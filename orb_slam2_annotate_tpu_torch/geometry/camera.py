"""Pinhole camera with radial-tangential distortion (port of geometry/camera.py).

``CameraModel`` holds Python floats.  Each value is first rounded to
float32, as the reference stores np.float32 scalars, so both packages
multiply by the same constants.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _f32(v) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class CameraModel:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0
    width: float = 640.0
    height: float = 480.0

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0, bf=0.0,
               width=640, height=480) -> "CameraModel":
        return CameraModel(*(_f32(v) for v in (fx, fy, cx, cy, k1, k2, p1, p2,
                                               k3, bf, width, height)))

    def K(self, device=None) -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx],
                             [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def distort_normalized(cam: CameraModel, xn: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coordinates [..., 2]."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xy = x * y
    xd = x * radial + 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * xy
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: CameraModel, xd: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Invert distortion by fixed-point iteration (cv::undistortPoints-style)."""
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
        xy = x * y
        dx = 2.0 * cam.p1 * xy + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * xy
        xn = torch.stack([(xd[..., 0] - dx) / radial, (xd[..., 1] - dy) / radial], dim=-1)
    return xn


def undistort_pixels(cam: CameraModel, uv: torch.Tensor) -> torch.Tensor:
    """Undistort raw pixel keypoints to ideal pinhole pixels [..., 2]."""
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    xn = undistort_normalized(cam, xd)
    return torch.stack([xn[..., 0] * cam.fx + cam.cx, xn[..., 1] * cam.fy + cam.cy], dim=-1)


def project(cam: CameraModel, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points [..., 3] -> ideal pixels [..., 2]."""
    z = xc[..., 2]
    z_safe = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * xc[..., 0] / z_safe + cam.cx
    v = cam.fy * xc[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: CameraModel, xc: torch.Tensor) -> torch.Tensor:
    """-> [u, v, u_right] with u_right = u - bf / z (the stereo residual's)."""
    uv = project(cam, xc)
    z = xc[..., 2]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    ur = uv[..., 0] - torch.full_like(z, cam.bf) / z
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(cam: CameraModel, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Ideal pixels [..., 2] + depth [...] -> camera-frame 3D [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def in_image(cam: CameraModel, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin))
