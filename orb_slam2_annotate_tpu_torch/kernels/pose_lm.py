"""Kernel 4: the whole pose-only LM (``optimize_pose``), batched over problems.

``optimize_pose_batched`` launches ``csrc/pose_lm.cu`` (one CTA per
problem over its compacted valid edges, the whole 4 x 5 LM schedule in one
launch) for CUDA tensors and runs its plain
twin, ``optimize_pose_plain`` once per problem, for CPU tensors;
``optimize_pose_batched.launches`` counts its kernel launches.
The twin is built from the steps below: ``pose_linearize_plain``,
``pose_costs_plain``, ``solve6_spd`` and ``se3_retract``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..geometry import lie
from ..geometry.smallsolve import solve6_spd
from . import _build

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
MAX_N = 4096        # edges a problem may have (csrc/pose_lm.cu)
SLOT_BYTES = 32     # shared memory a slot: 7 float planes, the compacted index, valid, mask
STATIC_SMEM = 8192  # at least the kernel's static shared memory (pose_lm_static_smem)
SMEM_PER_CTA = 232_448   # what an H100 CTA may use


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


def optimize_pose_plain(cam, R0, t0, xw, uv, ur, inv_sigma2, valid, rounds: int = 4,
                        iters_per_round: int = 5, lm_lambda0: float = 1e-3):
    """One problem (xw [N,3], uv [N,2], ur, inv_sigma2, valid [N]): rounds x
    iters LM iterations, each one linearization and a 3-value damping
    ladder, chi2 reclassification between rounds.  Accept/reject is
    ``torch.where`` on tensors, so the loop never reads the device.
    Returns (R, t, inlier [N], n int32)."""
    dev = xw.device
    delta2_all = _delta2(ur)
    ladder = torch.tensor([1.0, 8.0, 64.0], device=dev)
    eye6 = torch.eye(6, device=dev)
    R, t, inlier = R0, t0, valid
    for round_idx in range(rounds):
        robust = round_idx < 2
        mask = valid & inlier
        lam = torch.tensor(lm_lambda0, device=dev)
        for _ in range(iters_per_round):
            H, g, cost = pose_linearize_plain(cam, R, t, xw, uv, ur, inv_sigma2, mask, robust)
            lams = lam * ladder
            Hd = H + lams[:, None, None] * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            dx = -solve6_spd(Hd, g.expand(3, 6))
            R_a, t_a = lie.se3_retract(R.expand(3, 3, 3), t.expand(3, 3), dx)
            cost_a = pose_costs_plain(cam, R_a, t_a, xw, uv, ur, inv_sigma2, mask)
            improves = cost_a < cost
            pick = torch.argmax(improves.to(torch.uint8))      # smallest improving lambda
            any_imp = improves.any()
            R = torch.where(any_imp, R_a[pick], R)
            t = torch.where(any_imp, t_a[pick], t)
            lam = torch.clamp(torch.where(any_imp, lams[pick] * 0.4, lam * 512.0), 1e-9, 1e6)
        r, _, _, depth_ok = residual_jac(cam, R, t, xw, uv, ur)
        chi2 = torch.sum(r * r, dim=0) * inv_sigma2
        inlier = valid & (chi2 <= delta2_all) & depth_ok
    return R, t, inlier, torch.sum(inlier, dtype=torch.int32)


def _per_problem(a, b, shared_dim):
    return a if a.dim() == shared_dim else a[b]


def optimize_pose_batched_plain(cam, R0, t0, xw, uv, ur, inv_sigma2, valid, rounds: int = 4,
                                iters_per_round: int = 5, lm_lambda0: float = 1e-3):
    if xw.shape[0] == 0:
        return (R0.new_empty((0, 3, 3)), t0.new_empty((0, 3)), valid.new_empty(valid.shape),
                torch.empty((0,), dtype=torch.int32, device=xw.device))
    outs = [optimize_pose_plain(cam, R0[b], t0[b], xw[b], _per_problem(uv, b, 2),
                                _per_problem(ur, b, 1), _per_problem(inv_sigma2, b, 1), valid[b],
                                rounds, iters_per_round, lm_lambda0)
            for b in range(xw.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


@functools.cache
def _fn():
    fn = _build.load("pose_lm").pose_lm_solve_launch
    fn.argtypes = [ctypes.c_float] * 5 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 \
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def optimize_pose_batched(cam, R0, t0, xw, uv, ur, inv_sigma2, valid, rounds: int = 4,
                          iters_per_round: int = 5, lm_lambda0: float = 1e-3):
    """B independent pose-only LM problems: R0 [B,3,3], t0 [B,3], xw [B,N,3],
    valid [B,N] bool; uv [N,2] or [B,N,2], ur and inv_sigma2 [N] or [B,N]
    (one array shared by all problems, or one per problem).  Returns
    (R [B,3,3], t [B,3], inlier [B,N] bool, n [B] int32)."""
    if not xw.is_cuda:
        return optimize_pose_batched_plain(cam, R0, t0, xw, uv, ur, inv_sigma2, valid, rounds,
                                           iters_per_round, lm_lambda0)
    dev = xw.device
    B, N = xw.shape[0], xw.shape[1]
    if N > MAX_N:
        raise ValueError(f"optimize_pose_batched: {N} edges, the kernel takes at most {MAX_N}")
    R0, t0, xw, uv, ur, inv_sigma2, valid = (
        a.contiguous() for a in (R0, t0, xw, uv, ur, inv_sigma2, valid))
    f32 = torch.float32
    _build.check_tensor(R0, "R0", f32, (B, 3, 3), dev)
    _build.check_tensor(t0, "t0", f32, (B, 3), dev)
    _build.check_tensor(xw, "xw", f32, (B, N, 3), dev)
    _build.check_tensor(valid, "valid", torch.bool, (B, N), dev)
    strides = []
    for a, name, tail in ((uv, "uv", (2,)), (ur, "ur", ()), (inv_sigma2, "inv_sigma2", ())):
        shared = a.dim() == 1 + len(tail)
        _build.check_tensor(a, name, f32, (N, *tail) if shared else (B, N, *tail), dev)
        strides.append(0 if shared else a.stride(0))
    R = torch.empty((B, 3, 3), dtype=f32, device=dev)
    t = torch.empty((B, 3), dtype=f32, device=dev)
    inlier = torch.empty((B, N), dtype=torch.bool, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return R, t, inlier, n
    err = _fn()(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, R0.data_ptr(), t0.data_ptr(),
                xw.data_ptr(), uv.data_ptr(), ur.data_ptr(), inv_sigma2.data_ptr(),
                valid.data_ptr(), B, N, *strides, rounds, iters_per_round, lm_lambda0,
                R.data_ptr(), t.data_ptr(), inlier.data_ptr(), n.data_ptr(),
                _build.stream_ptr(dev))
    _build.check_launch(err, "pose_lm_solve")
    optimize_pose_batched.launches += 1
    return R, t, inlier, n


optimize_pose_batched.launches = 0
