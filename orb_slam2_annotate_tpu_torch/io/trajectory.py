"""Trajectory export in TUM and KITTI formats (port of io/trajectory.py).

Both write camera-to-world poses (Twc), as the reference's
SaveTrajectoryTUM / SaveTrajectoryKITTI do (System.cc:327-477).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import lie


def _invert(T: np.ndarray) -> np.ndarray:
    R, t = T[:3, :3], T[:3, 3]
    Ti = np.eye(4, dtype=T.dtype)
    Ti[:3, :3] = R.T
    Ti[:3, 3] = -R.T @ t
    return Ti


def save_tum(path: str, stamped_poses):
    """stamped_poses: iterable of (timestamp, 4x4 Tcw or None).  Writes
    `timestamp tx ty tz qx qy qz qw` of Twc a line; None is skipped."""
    with open(path, "w") as f:
        for ts, Tcw in stamped_poses:
            if Tcw is None:
                continue
            Twc = _invert(np.asarray(Tcw))
            # in float32, as the reference's (JAX's default) precision
            q = lie.rot_to_quat(torch.from_numpy(Twc[:3, :3].astype(np.float32))).numpy()
            t = Twc[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")


def save_kitti(path: str, poses):
    """poses: iterable of 4x4 Tcw or None.  Writes Twc's 3x4 rows, row-major,
    a line; None is skipped."""
    with open(path, "w") as f:
        for Tcw in poses:
            if Tcw is None:
                continue
            r = _invert(np.asarray(Tcw))[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in r) + "\n")


def load_tum(path: str):
    """(timestamps [N], positions [N,3], quaternions [N,4]) of a TUM file."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]
