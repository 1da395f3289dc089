"""Trajectory evaluation: ATE / RPE with Sim3 (Umeyama) alignment.

A numpy copy of orb_slam2_annotate_tpu/io/evaluation.py (importing the
reference package would import jax); tests/test_torch_system.py checks that
the two agree.

The reference delegates this to the external TUM benchmark tools
(README.md:163-166); we ship it because accuracy is a first-class test
criterion (SURVEY §4): integration tests assert ATE RMSE thresholds.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    src, dst: [N,3].  Returns (s, R, t) with dst ~ s R src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, with_scale: bool = True):
    """Absolute trajectory error after Sim3/SE3 alignment.

    est_pos, gt_pos: [N,3] matched camera centers.
    Returns (rmse, aligned_est).
    """
    s, R, t = umeyama_alignment(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    err = np.linalg.norm(aligned - gt_pos, axis=1)
    return float(np.sqrt((err**2).mean())), aligned


def rpe(est_poses: list[np.ndarray], gt_poses: list[np.ndarray], delta: int = 1):
    """Relative pose error over Twc 4x4 lists.  Returns (trans_rmse, rot_rmse_rad)."""
    et, er = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        et.append(np.linalg.norm(e[:3, 3]))
        ang = np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1))
        er.append(ang)
    return float(np.sqrt(np.mean(np.square(et)))), float(np.sqrt(np.mean(np.square(er))))
