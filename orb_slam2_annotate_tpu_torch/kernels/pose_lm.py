"""Kernel 4: pose-only LM linearization and batched Huber cost.

``pose_linearize`` and ``pose_costs`` launch ``csrc/pose_lm.cu`` for CUDA
tensors and run their plain twins for CPU tensors; each wrapper's
``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def residual_jac(cam, R, t, xw, uv, ur):
    """Residuals and Jacobians against the left se3 update, plane layout:
    (r [3,N], J [3,6,N], is_stereo [N], depth_ok [N])."""
    xc = xw @ R.T + t
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    depth_ok = z > 1e-3
    z_safe = torch.where(z < 1e-3, torch.full_like(z, 1e-3), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur_pred = u - cam.bf * iz
    is_stereo = ur >= 0
    zeros = torch.zeros_like(x)
    r = torch.stack([u - uv[:, 0], v - uv[:, 1],
                     torch.where(is_stereo, ur_pred - ur, zeros)], dim=0)
    du = (cam.fx * iz, zeros, -cam.fx * x * iz2)
    dv = (zeros, cam.fy * iz, -cam.fy * y * iz2)
    dr = (torch.where(is_stereo, du[0], zeros), zeros,
          torch.where(is_stereo, du[2] + cam.bf * iz2, zeros))

    def jrow(d):
        dx, dy, dz = d
        return torch.stack([dx, dy, dz, dz * y - dy * z, dx * z - dz * x, dy * x - dx * y], dim=0)

    J = torch.stack([jrow(du), jrow(dv), jrow(dr)], dim=0)
    return r, J, is_stereo, depth_ok


def _delta2(ur):
    return torch.where(ur >= 0, CHI2_STEREO, CHI2_MONO)


def pose_cost_plain(cam, R, t, xw, uv, ur, inv_sigma2, mask):
    """Huberized chi2 cost of one pose over the masked edges (0-d)."""
    xc = xw @ R.T + t
    z = xc[:, 2]
    depth_ok = z > 1e-3
    z_safe = torch.where(depth_ok, z, torch.full_like(z, 1e-3))
    u = cam.fx * xc[:, 0] / z_safe + cam.cx
    v = cam.fy * xc[:, 1] / z_safe + cam.cy
    ur_pred = u - cam.bf / z_safe
    is_stereo = ur >= 0
    e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2 + torch.where(
        is_stereo, (ur_pred - ur) ** 2, torch.zeros_like(u))
    chi2 = e2 * inv_sigma2
    delta2 = _delta2(ur)
    hub = torch.where(chi2 > delta2, 2.0 * torch.sqrt(delta2 * torch.clamp_min(chi2, 0.0)) - delta2,
                      chi2)
    hub = torch.where(depth_ok, hub, 100.0 * delta2)
    return torch.sum(hub * mask.to(hub.dtype))


def pose_linearize_plain(cam, R, t, xw, uv, ur, inv_sigma2, mask, robust: bool):
    """(H [6,6], g [6], cost 0-d) of one LM linearization."""
    r, J, is_stereo, depth_ok = residual_jac(cam, R, t, xw, uv, ur)
    chi2 = torch.sum(r * r, dim=0) * inv_sigma2
    delta2 = _delta2(ur)
    w_h = torch.where(chi2 > delta2, torch.sqrt(delta2 / torch.clamp_min(chi2, 1e-12)),
                      torch.ones_like(chi2))
    if not robust:
        w_h = torch.ones_like(chi2)
    w = inv_sigma2 * w_h * (mask & depth_ok).to(chi2.dtype)
    Jw = J * w[None, None, :]
    H = torch.einsum("rin,rjn->ij", Jw, J)
    g = torch.einsum("rin,rn->i", Jw, r)
    return H, g, pose_cost_plain(cam, R, t, xw, uv, ur, inv_sigma2, mask)


def pose_costs_plain(cam, Rs, ts, xw, uv, ur, inv_sigma2, mask):
    """[B] costs of B candidate poses."""
    return torch.stack([pose_cost_plain(cam, Rs[b], ts[b], xw, uv, ur, inv_sigma2, mask)
                        for b in range(Rs.shape[0])])


@functools.cache
def _fns():
    lib = _build.load("pose_lm")
    lin = lib.pose_linearize_launch
    lin.argtypes = [ctypes.c_float] * 5 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p] * 2
    lin.restype = ctypes.c_int
    cost = lib.pose_cost_launch
    cost.argtypes = [ctypes.c_float] * 5 + [ctypes.c_void_p] * 2 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    cost.restype = ctypes.c_int
    return lin, cost


def _check_edges(xw, uv, ur, inv_sigma2, mask):
    dev, N = xw.device, xw.shape[0]
    for t, name, dt, shape in ((xw, "xw", torch.float32, (N, 3)), (uv, "uv", torch.float32, (N, 2)),
                               (ur, "ur", torch.float32, (N,)),
                               (inv_sigma2, "inv_sigma2", torch.float32, (N,)),
                               (mask, "mask", torch.bool, (N,))):
        _build.check_tensor(t, name, dt, shape, dev)
    return dev, N


def pose_linearize(cam, R, t, xw, uv, ur, inv_sigma2, mask, robust: bool):
    if not xw.is_cuda:
        return pose_linearize_plain(cam, R, t, xw, uv, ur, inv_sigma2, mask, robust)
    dev, N = _check_edges(xw, uv, ur, inv_sigma2, mask)
    R = R.contiguous()
    t = t.contiguous()
    _build.check_tensor(R, "R", torch.float32, (3, 3), dev)
    _build.check_tensor(t, "t", torch.float32, (3,), dev)
    out = torch.empty((43,), dtype=torch.float32, device=dev)
    lin, _ = _fns()
    err = lin(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, R.data_ptr(), t.data_ptr(), xw.data_ptr(),
              uv.data_ptr(), ur.data_ptr(), inv_sigma2.data_ptr(), mask.data_ptr(), N,
              int(bool(robust)), out.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "pose_linearize")
    pose_linearize.launches += 1
    return out[:36].reshape(6, 6), out[36:42], out[42]


def pose_costs(cam, Rs, ts, xw, uv, ur, inv_sigma2, mask):
    if not xw.is_cuda:
        return pose_costs_plain(cam, Rs, ts, xw, uv, ur, inv_sigma2, mask)
    dev, N = _check_edges(xw, uv, ur, inv_sigma2, mask)
    B = Rs.shape[0]
    Rs = Rs.contiguous()
    ts = ts.contiguous()
    _build.check_tensor(Rs, "Rs", torch.float32, (B, 3, 3), dev)
    _build.check_tensor(ts, "ts", torch.float32, (B, 3), dev)
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    _, cost = _fns()
    err = cost(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, Rs.data_ptr(), ts.data_ptr(), B,
               xw.data_ptr(), uv.data_ptr(), ur.data_ptr(), inv_sigma2.data_ptr(), mask.data_ptr(),
               N, out.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "pose_costs")
    pose_costs.launches += 1
    return out


pose_linearize.launches = 0
pose_costs.launches = 0
