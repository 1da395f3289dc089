"""Stereo rectification (port of geometry/rectify.py): undistort-rectify
maps made once on the host, and each pair remapped by kernel 10.

``rectify_map`` follows cv::initUndistortRectifyMap: each rectified pixel is
back-projected through the new projection P, rotated by R^-1 into the
original camera, distorted and projected with the original K.
``stereo_rectify`` is the reference's Bouguet-style split of the relative
rotation, in float64 on the host.  ``StereoRectifier`` holds both maps on
its device, checked once, and rectifies a pair in one kernel-10 launch
(``kernels.remap.launch``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import remap
from . import lie
from .camera import CameraModel, distort_normalized


def rectify_map(K, dist, R, P, height: int, width: int, device=None) -> torch.Tensor:
    """Source-pixel lookup map of the rectified image, [H, W, 2] (x, y) f32.

    K [3,3] original intrinsics; dist [<=5] (k1, k2, p1, p2, k3); R [3,3]
    rectifying rotation; P [3,3] or [3,4] new projection."""
    K = np.asarray(K, np.float32)
    dist = np.pad(np.asarray(dist, np.float32).ravel(), (0, 5))[:5]
    R = np.asarray(R, np.float32)
    P = np.asarray(P, np.float32)[:3, :3]
    u, v = np.meshgrid(np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32))
    pix = np.stack([u, v, np.ones_like(u)], -1).reshape(-1, 3)
    rays = pix @ np.linalg.inv(P).T @ np.linalg.inv(R).T
    xn = rays[:, :2] / np.maximum(rays[:, 2:3], 1e-9)
    cam = CameraModel.create(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], k1=dist[0],
                             k2=dist[1], p1=dist[2], p2=dist[3], k3=dist[4], width=width,
                             height=height)
    xd = distort_normalized(cam, torch.from_numpy(np.ascontiguousarray(xn))).numpy()
    src = np.stack([K[0, 0] * xd[:, 0] + K[0, 2], K[1, 1] * xd[:, 1] + K[1, 2]], -1)
    return torch.from_numpy(src.reshape(height, width, 2).astype(np.float32)).to(device)


def stereo_rectify(K1, D1, K2, D2, R, t, height: int, width: int):
    """Bouguet rectification from relative extrinsics (x2 = R x1 + t).

    Returns (R1, R2, P1, P2, bf): each camera's rectifying rotation, the
    shared new projection (P2 carries the baseline), and bf = f * baseline.
    The new principal point is the mean of the two, the new focal the mean
    fy (cv::stereoRectify with alpha = 0, without its crop search)."""
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64).ravel()

    # the relative rotation split evenly between the two cameras
    om = lie.so3_log(torch.tensor(R, dtype=torch.float32)).double().numpy()
    r_half = lie.so3_exp(torch.tensor(-om / 2, dtype=torch.float32)).double().numpy()
    t_half = r_half @ t

    # the new x-axis along the baseline, +x to the right so disparity is positive
    e1 = t_half / np.linalg.norm(t_half)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.cross([0.0, 0.0, 1.0], e1)
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    R_rect = np.stack([e1, e2, e3])
    R2 = R_rect @ r_half
    R1 = R2 @ R           # so that R2 @ R @ R1^T = I

    f = 0.5 * (K1[1, 1] + K2[1, 1])
    cx = 0.5 * (K1[0, 2] + K2[0, 2])
    cy = 0.5 * (K1[1, 2] + K2[1, 2])
    Knew = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
    baseline = np.linalg.norm(t)
    P1 = np.concatenate([Knew, np.zeros((3, 1), np.float32)], 1)
    P2 = P1.copy()
    P2[0, 3] = -f * baseline   # left camera at the origin, the right along -x
    return R1.astype(np.float32), R2.astype(np.float32), P1, P2, float(f * baseline)


class StereoRectifier:
    """Both cameras' maps on `device`, checked once for kernel 10 where they
    are made; a call rectifies a pair in one launch."""

    def __init__(self, K_l, D_l, R_l, P_l, K_r, D_r, R_r, P_r, height: int, width: int,
                 device="cuda"):
        self._map_l = rectify_map(K_l, D_l, R_l, P_l, height, width, torch.device(device))
        self._map_r = rectify_map(K_r, D_r, R_r, P_r, height, width, torch.device(device))
        self.device = self._map_l.device      # with its index: "cuda" is "cuda:<current>"
        self._checked = (remap.check_maps(self._map_l, self._map_r, self.device)
                         if self.device.type == "cuda" else None)
        P_l = np.asarray(P_l, np.float32)
        self.cam = CameraModel.create(fx=P_l[0, 0], fy=P_l[1, 1], cx=P_l[0, 2], cy=P_l[1, 2],
                                      width=width, height=height)

    # read-only: kernel 10 reads the pointers checked at construction
    @property
    def map_l(self) -> torch.Tensor:
        return self._map_l

    @property
    def map_r(self) -> torch.Tensor:
        return self._map_r

    def _as_f32(self, im):
        """im as an f32 contiguous tensor on the rectifier's device: as it is
        when it already is one."""
        if (type(im) is torch.Tensor and im.dtype is torch.float32 and im.device == self.device
                and im.is_contiguous()):
            return im
        return torch.as_tensor(im).to(self.device, torch.float32).contiguous()

    def __call__(self, img_l, img_r):
        """Images [H, W] (numpy or tensors, any real type) -> the rectified
        pair, f32 tensors on the rectifier's device."""
        img_l, img_r = self._as_f32(img_l), self._as_f32(img_r)
        if self._checked is None:
            return remap.remap_pair(img_l, img_r, self._map_l, self._map_r)
        # _as_f32 leaves kernel 10's image checks to the shapes
        H, W = img_l.shape
        if img_r.shape != (H, W):
            raise ValueError(f"img_r: expected shape {(H, W)}, got {tuple(img_r.shape)}")
        return remap.launch(img_l, img_r, H, W, *self._checked)
