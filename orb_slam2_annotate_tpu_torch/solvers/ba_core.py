"""Bundle adjustment (port of solvers/ba_core.py): the grid BA of local
mapping, a robust LM with a dense Schur solve over a [C, N] keyframe-feature
grid, and the padded edge-list problem (``BAProblem``, ``edge_residual_jac``)
that the global BA of ``solvers/ba_cg.py`` solves.

Same plane layout as the reference (Jacobian axes first, big axes last).
The 6C x 6C reduced camera system is solved by Cholesky; where it is not
positive definite the step is NaN, as the reference's
``jax.scipy.linalg.solve(assume_a="pos")`` gives, and is rejected.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie
from ..geometry.camera import CameraModel

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


@dataclasses.dataclass
class GridBA:
    R: torch.Tensor            # [C,3,3]
    t: torch.Tensor            # [C,3]
    points: torch.Tensor       # [P,3]
    cam_fixed: torch.Tensor    # [C] bool
    cam_valid: torch.Tensor    # [C] bool
    pt_valid: torch.Tensor     # [P] bool
    pt_loc: torch.Tensor       # [C,N] int (-1 = no edge)
    uv: torch.Tensor           # [C,N,2]
    ur: torch.Tensor           # [C,N]
    inv_sigma2: torch.Tensor   # [C,N]
    edge_valid: torch.Tensor   # [C,N] bool


@dataclasses.dataclass
class BAProblem:
    """Padded edge-list BA problem: poses R [C,3,3], t [C,3] world->cam;
    points [P,3]; cam_fixed, cam_valid [C] and pt_valid [P] bool; edges
    cam_idx, pt_idx [E] int, uv [E,2], ur [E] (< 0: mono), inv_sigma2 [E],
    edge_valid [E] bool."""

    R: torch.Tensor
    t: torch.Tensor
    points: torch.Tensor
    cam_fixed: torch.Tensor
    cam_valid: torch.Tensor
    pt_valid: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    ur: torch.Tensor
    inv_sigma2: torch.Tensor
    edge_valid: torch.Tensor

    def replace(self, **kw) -> "BAProblem":
        return dataclasses.replace(self, **kw)


def edge_residual_jac(cam: CameraModel, prob: BAProblem):
    """r [E,3], Jc [E,3,6] (left se3 update of the edge's camera), Jp [E,3,3]
    (the world point), is_stereo [E], depth_ok [E]."""
    ci, pi = prob.cam_idx.long(), prob.pt_idx.long()
    Re = prob.R[ci]
    xc = torch.einsum("eij,ej->ei", Re, prob.points[pi]) + prob.t[ci]
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    depth_ok = z > 1e-3
    z_safe = torch.where(z < 1e-3, torch.full_like(z, 1e-3), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur_pred = u - cam.bf * iz
    is_stereo = prob.ur >= 0
    zeros = torch.zeros_like(x)
    r = torch.stack([u - prob.uv[:, 0], v - prob.uv[:, 1],
                     torch.where(is_stereo, ur_pred - prob.ur, zeros)], dim=1)
    du = torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], dim=1)
    dv = torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], dim=1)
    dr = du + torch.stack([zeros, zeros, cam.bf * iz2], dim=1)
    dr = torch.where(is_stereo[:, None], dr, 0.0)
    dpix = torch.stack([du, dv, dr], dim=1)
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[0], 3, 3)
    Jc = dpix @ torch.cat([eye, -lie.hat(xc)], dim=2)
    return r, Jc, dpix @ Re, is_stereo, depth_ok


def edge_chi2(r, inv_sigma2):
    return torch.sum(r * r, dim=1) * inv_sigma2


def _project_planes(cam, R, t, X, g):
    Xg = X[torch.clamp_min(g.pt_loc, 0).long()]                 # [C,N,3]
    return torch.einsum("cij,cnj->cin", R, Xg) + t[:, :, None]   # [C,3,N]


def _delta2(ur):
    return torch.where(ur >= 0, CHI2_STEREO, CHI2_MONO)


def _huber(chi2, delta2, depth_ok):
    hub = torch.where(chi2 > delta2, 2.0 * torch.sqrt(delta2 * torch.clamp_min(chi2, 0.0)) - delta2,
                      chi2)
    return torch.where(depth_ok, hub, 100.0 * delta2)


def grid_cost(cam: CameraModel, R, t, X, g: GridBA, chi2_out: bool = False):
    """Huberized cost (no Jacobians)."""
    xc = _project_planes(cam, R, t, X, g)
    z = xc[:, 2]
    depth_ok = z > 1e-3
    z_safe = torch.where(z < 1e-3, torch.full_like(z, 1e-3), z)
    u = cam.fx * xc[:, 0] / z_safe + cam.cx
    v = cam.fy * xc[:, 1] / z_safe + cam.cy
    ur_pred = u - cam.bf / z_safe
    is_stereo = g.ur >= 0
    e2 = (u - g.uv[..., 0]) ** 2 + (v - g.uv[..., 1]) ** 2 + torch.where(
        is_stereo, (ur_pred - g.ur) ** 2, torch.zeros_like(u))
    chi2 = e2 * g.inv_sigma2
    delta2 = _delta2(g.ur)
    cost = torch.sum(_huber(chi2, delta2, depth_ok) * g.edge_valid.to(chi2.dtype))
    if chi2_out:
        return cost, chi2, delta2, depth_ok
    return cost


def _inv3_planes(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [3, 3, ...] matrices (matrix dims lead)."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    co = [[e * i - f * h, c * h - b * i, b * f - c * e],
          [f * g - d * i, a * i - c * g, c * d - a * f],
          [d * h - e * g, b * g - a * h, a * e - b * d]]
    det = a * co[0][0] + b * co[1][0] + c * co[2][0]
    tiny = torch.where(det < 0, -1e-20, 1e-20)
    det_safe = torch.where(det.abs() < 1e-20, tiny, det)
    inv = torch.stack([torch.stack(row, dim=0) for row in co], dim=0)
    return inv / det_safe[None, None]


def grid_residual_jac(cam: CameraModel, R, t, X, g: GridBA):
    """r [3,C,N], Jc [3,6,C,N], Jp [3,3,C,N], is_stereo [C,N], depth_ok [C,N]."""
    xc = _project_planes(cam, R, t, X, g)
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    depth_ok = z > 1e-3
    z_safe = torch.where(z < 1e-3, torch.full_like(z, 1e-3), z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur_pred = u - cam.bf * iz
    is_stereo = g.ur >= 0
    zeros = torch.zeros_like(x)
    r = torch.stack([u - g.uv[..., 0], v - g.uv[..., 1],
                     torch.where(is_stereo, ur_pred - g.ur, zeros)], dim=0)
    du = (cam.fx * iz, zeros, -cam.fx * x * iz2)
    dv = (zeros, cam.fy * iz, -cam.fy * y * iz2)
    dr = (torch.where(is_stereo, du[0], zeros), zeros,
          torch.where(is_stereo, du[2] + cam.bf * iz2, zeros))

    def jrow_cam(d):
        dx, dy, dz = d
        return torch.stack([dx, dy, dz, dz * y - dy * z, dx * z - dz * x, dy * x - dx * y], dim=0)

    def jrow_pt(d):
        return torch.einsum("icn,cij->jcn", torch.stack(d, dim=0), R)

    Jc = torch.stack([jrow_cam(du), jrow_cam(dv), jrow_cam(dr)], dim=0)
    Jp = torch.stack([jrow_pt(du), jrow_pt(dv), jrow_pt(dr)], dim=0)
    return r, Jc, Jp, is_stereo, depth_ok


def _damp_blocks(H, lam, eps=1e-9):
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + torch.diag_embed(lam * d + eps)


def schur_solve_planes(Hcc, Hpp, B, gc, gp, lam, cam_free_mask):
    """Hcc [C,6,6], Hpp [3,3,P], B [6,3,C,P], gc [C,6], gp [3,P] ->
    (dc [C,6], dp [P,3])."""
    C = Hcc.shape[0]
    dev = Hcc.device
    eye3 = torch.eye(3, device=dev)[:, :, None]
    Hcc_d = _damp_blocks(Hcc, lam)
    dg = torch.stack([Hpp[0, 0], Hpp[1, 1], Hpp[2, 2]], dim=0)
    Hpp_d = Hpp + eye3 * (lam * dg + 1e-9)[:, None, :]
    Hpp_inv = _inv3_planes(Hpp_d + 1e-8 * eye3)
    BH = torch.einsum("ikcp,kjp->ijcp", B, Hpp_inv)
    S = -torch.einsum("ikcp,lkdp->cdil", BH, B)
    ar = torch.arange(C, device=dev)
    S[ar, ar] += Hcc_d
    rhs = -gc + torch.einsum("ikcp,kp->ci", BH, gp)
    Sf = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    mask6 = cam_free_mask.repeat_interleave(6)
    Sf = torch.where(mask6[:, None] & mask6[None, :], Sf, torch.zeros_like(Sf))
    Sf = Sf + torch.diag(torch.where(mask6, 0.0, 1.0))
    rf = torch.where(mask6, rhs.reshape(-1), torch.zeros_like(rhs.reshape(-1)))
    L, info = torch.linalg.cholesky_ex(Sf)
    dc = torch.cholesky_solve(rf[:, None], L)[:, 0]
    dc = torch.where(info == 0, dc, torch.full_like(dc, float("nan"))).reshape(C, 6)
    dc = torch.where(cam_free_mask[:, None], dc, torch.zeros_like(dc))
    Btdc = torch.einsum("ikcp,ci->kp", B, dc)
    dp = torch.einsum("jkp,kp->jp", Hpp_inv, -gp - Btdc)
    return dc, dp.T


def bundle_adjust_grid(cam: CameraModel, g: GridBA, iters: int = 10, robust: bool = True,
                       lam0: float = 1e-5, lam_ladder: tuple = (1.0, 8.0, 64.0)):
    """Returns (R [C,3,3], t [C,3], points [P,3], edge_inlier [C,N], cost)."""
    C, N = g.pt_loc.shape
    P = g.points.shape[0]
    dev = g.points.device
    cam_free = g.cam_valid & ~g.cam_fixed
    base_valid = g.edge_valid & (g.pt_loc >= 0)

    # one-time (point, cam) -> feature inverse index, N = no observation
    cam_ids = torch.arange(C, device=dev)[:, None].expand(C, N)
    n_ids = torch.arange(N, device=dev, dtype=torch.int32)[None, :].expand(C, N)
    lin = torch.clamp_min(g.pt_loc, 0).long() * C + cam_ids
    inv = torch.full((P * C,), N, dtype=torch.int32, device=dev).scatter_reduce(
        0, lin.reshape(-1), torch.where(base_valid, n_ids, N).reshape(-1), "amin").reshape(P, C)
    selT = (inv.long() + torch.arange(C, device=dev)[None, :] * (N + 1)).T      # [C,P]

    def take(a):
        ap = torch.nn.functional.pad(a, (0, 1))
        return ap.reshape(a.shape[:-2] + (-1,))[..., selT]

    def linearize(R, t, X):
        r, Jc, Jp, is_stereo, depth_ok = grid_residual_jac(cam, R, t, X, g)
        chi2 = torch.sum(r * r, dim=0) * g.inv_sigma2
        delta2 = _delta2(g.ur)
        w_h = torch.where(chi2 > delta2, torch.sqrt(delta2 / torch.clamp_min(chi2, 1e-12)),
                          torch.ones_like(chi2))
        if not robust:
            w_h = torch.ones_like(chi2)
        w = g.inv_sigma2 * w_h * (base_valid & depth_ok).to(chi2.dtype)
        sw = torch.sqrt(w)[None, None]
        Jc = torch.where(g.cam_fixed[None, None, :, None], torch.zeros_like(Jc), Jc)
        Jcw = Jc * sw
        Jpw = Jp * sw
        rw = r * sw[0]
        Hcc = torch.einsum("ricn,rjcn->cij", Jcw, Jcw)
        gc = torch.einsum("ricn,rcn->ci", Jcw, rw)
        Jp_pc = take(Jpw)
        Jcw_pc = take(Jcw)
        r_pc = take(rw)
        Hpp = torch.einsum("rjcp,rkcp->jkp", Jp_pc, Jp_pc)
        gp = torch.einsum("rjcp,rcp->jp", Jp_pc, r_pc)
        B = torch.einsum("ricp,rkcp->ikcp", Jcw_pc, Jp_pc)
        cost = torch.sum(_huber(chi2, delta2, depth_ok) * base_valid.to(chi2.dtype))
        return Hcc, Hpp, B, gc, gp, cost

    R, t, X = g.R, g.t, g.points
    lam = torch.tensor(lam0, device=dev)
    ladder = torch.tensor(lam_ladder, device=dev)
    ptv = g.pt_valid[:, None].to(X.dtype)
    cost_new = None
    for _ in range(iters):
        Hcc, Hpp, B, gc, gp, cost = linearize(R, t, X)
        lams = lam * ladder
        tries = []
        for k in range(len(lam_ladder)):
            dc, dp = schur_solve_planes(Hcc, Hpp, B, gc, gp, lams[k], cam_free)
            R_n, t_n = lie.se3_retract(R, t, dc)
            X_n = X + dp * ptv
            tries.append((R_n, t_n, X_n, grid_cost(cam, R_n, t_n, X_n, g)))
        R_a, t_a, X_a, cost_a = (torch.stack(z) for z in zip(*tries))
        improves = cost_a < cost
        pick = torch.argmax(improves.to(torch.uint8))
        any_imp = improves.any()
        R = torch.where(any_imp, R_a[pick], R)
        t = torch.where(any_imp, t_a[pick], t)
        X = torch.where(any_imp, X_a[pick], X)
        cost_new = torch.where(any_imp, cost_a[pick], cost)
        lam = torch.clamp(torch.where(any_imp, lams[pick] * 0.3, lam * 512.0), 1e-9, 1e6)
    _, chi2, delta2, depth_ok = grid_cost(cam, R, t, X, g, chi2_out=True)
    inlier = base_valid & (chi2 <= delta2) & depth_ok
    return R, t, X, inlier, cost_new
