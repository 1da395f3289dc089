"""Bundle adjustment (port of solvers/ba_core.py): the grid BA of local
mapping, a robust LM with a dense Schur solve over a [C, N] keyframe-feature
grid; and the padded edge-list problem (``BAProblem``) with its dense
robust LM (``build_normal_eqs``, ``schur_solve_dense``, ``bundle_adjust``),
whose normal equations the distributed BA of ``parallel/dist_ba.py`` builds
per shard, and which the global BA of ``solvers/ba_cg.py`` solves matrix-free.

Same plane layout as the reference (Jacobian axes first, big axes last).
The 6C x 6C reduced camera system is solved by Cholesky; where it is not
positive definite the step is NaN, as the reference's
``jax.scipy.linalg.solve(assume_a="pos")`` gives, and is rejected.  The
edge-list sums are kernel 11's segment sums (``kernels/segment_sum``), in
ascending edge order on the card as on the CPU, and the Cholesky kernel
12b's (``kernels/chol_solve``), in one fixed order.  The grid BA on the card
is kernel 12 (``kernels/grid_ba``); ``bundle_adjust_grid_plain`` is its twin.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie
from ..geometry.camera import CameraModel
from ..geometry.lie import dot3, via_f64
from ..geometry.smallsolve import inv3
from ..kernels import grid_ba
from ..kernels.chol_solve import chol_solve
from ..kernels.segment_sum import segment_plan, segment_sum

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


# The edge-list BA computes in one order on every device, so the card gives
# the CPU's bits: products and their three-term sums written out
# (``lie.dot3``), every longer sum kernel 11's fixed order, square roots
# ``lie.via_f64``, divisions by tensors (the card multiplies by the
# reciprocal of a Python number), the reduced system factored and solved by
# kernel 12b (``kernels/chol_solve``).  The LM of a map whose scale only
# the damping holds moves its returned state's cost by ~1e-5 relative for
# one float32 ulp of its input, so any device difference in a sum's order, a
# product's fused multiply-add or a square root's last bit would make the
# card's result a draw against the CPU's.

def edge_residual_jac(cam: CameraModel, prob: BAProblem, jacobians: bool = True):
    """r [E,3], Jc [E,3,6] (left se3 update of the edge's camera), Jp [E,3,3]
    (the world point), is_stereo [E], depth_ok [E]; Jc and Jp None without
    `jacobians`."""
    ci, pi = prob.cam_idx.long(), prob.pt_idx.long()
    Re, te, Xe = prob.R[ci], prob.t[ci], prob.points[pi]
    x, y, z = (dot3(Re[:, k, 0], Xe[:, 0], Re[:, k, 1], Xe[:, 1], Re[:, k, 2], Xe[:, 2]) + te[:, k]
               for k in range(3))
    depth_ok = z > 1e-3
    z_safe = torch.where(z < 1e-3, torch.full_like(z, 1e-3), z)
    iz = 1.0 / z_safe
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur_pred = u - cam.bf * iz
    is_stereo = prob.ur >= 0
    zeros = torch.zeros_like(x)
    r = torch.stack([u - prob.uv[:, 0], v - prob.uv[:, 1],
                     torch.where(is_stereo, ur_pred - prob.ur, zeros)], dim=1)
    if not jacobians:
        return r, None, None, is_stereo, depth_ok
    iz2 = iz * iz
    du0, du2 = cam.fx * iz, -cam.fx * x * iz2
    rows = ((du0, zeros, du2), (zeros, cam.fy * iz, -cam.fy * y * iz2),
            (torch.where(is_stereo, du0, zeros), zeros,
             torch.where(is_stereo, du2 + cam.bf * iz2, zeros)))
    Jc = torch.stack([torch.stack([dx, dy, dz, dz * y - dy * z, dx * z - dz * x, dy * x - dx * y],
                                  dim=1) for dx, dy, dz in rows], dim=1)
    Jp = torch.stack([torch.stack([dot3(dx, Re[:, 0, j], dy, Re[:, 1, j], dz, Re[:, 2, j])
                                   for j in range(3)], dim=1) for dx, dy, dz in rows], dim=1)
    return r, Jc, Jp, is_stereo, depth_ok


def edge_chi2(r, inv_sigma2):
    return dot3(r[:, 0], r[:, 0], r[:, 1], r[:, 1], r[:, 2], r[:, 2]) * inv_sigma2


def edge_cost(cam: CameraModel, prob: BAProblem, plan_all=None) -> torch.Tensor:
    """The Huberized cost over the valid edges (behind-camera edges pay a
    flat barrier), without Jacobians: the number ``build_normal_eqs``
    returns for the same state.  `plan_all`: ``normal_eq_plans(prob)[3]``,
    made here when not given."""
    if plan_all is None:
        plan_all = _plan_all(prob)
    r, _, _, _, depth_ok = edge_residual_jac(cam, prob, jacobians=False)
    hub = _huber(edge_chi2(r, prob.inv_sigma2), _delta2(prob.ur), depth_ok)
    return segment_sum(plan_all, (hub * prob.edge_valid.to(hub.dtype))[:, None])[0, 0]


def _plan_all(prob: BAProblem):
    return segment_plan(torch.zeros_like(prob.cam_idx), 1)


def normal_eq_plans(prob: BAProblem):
    """The segment plans of ``build_normal_eqs``'s sums, over the cameras,
    the points and the (point, camera) pairs (an invalid edge weighs 0, its
    terms are ±0, so it is left out), then over every edge for the cost:
    built once a solve."""
    C, P = prob.R.shape[0], prob.points.shape[0]
    ci, pi, ok = prob.cam_idx.long(), prob.pt_idx.long(), prob.edge_valid
    return (segment_plan(torch.where(ok, ci, -1), C), segment_plan(torch.where(ok, pi, -1), P),
            segment_plan(torch.where(ok, pi * C + ci, -1), P * C), _plan_all(prob))


def _products3(A, Bm):
    """[E,3,a] x [E,3,b] -> [E,a,b], the sum over the three rows in order."""
    return (A[:, 0, :, None] * Bm[:, 0, None, :] + A[:, 1, :, None] * Bm[:, 1, None, :]
            + A[:, 2, :, None] * Bm[:, 2, None, :])


def build_normal_eqs(cam: CameraModel, prob: BAProblem, robust: bool, plans=None):
    """One linearization: Hcc [C,6,6] (diagonal blocks), Hpp [P,3,3],
    B [P,C,6,3] (camera-point coupling, summed per (point, camera)),
    gc [C,6], gp [P,3] and the cost.  `plans`: ``normal_eq_plans(prob)``,
    made here when not given."""
    C, P = prob.R.shape[0], prob.points.shape[0]
    ci = prob.cam_idx.long()
    plan_c, plan_p, plan_pc, plan_all = normal_eq_plans(prob) if plans is None else plans
    r, Jc, Jp, is_stereo, depth_ok = edge_residual_jac(cam, prob)
    chi2 = edge_chi2(r, prob.inv_sigma2)
    delta2 = _delta2(prob.ur)
    w_h = torch.ones_like(chi2)
    if robust:
        w_h = torch.where(chi2 > delta2, via_f64(torch.sqrt, delta2 / torch.clamp_min(chi2, 1e-12)),
                          w_h)
    w = prob.inv_sigma2 * w_h * (prob.edge_valid & depth_ok).to(chi2.dtype)
    Jc = torch.where(prob.cam_fixed[ci][:, None, None], 0.0, Jc)
    Jcw, Jpw = Jc * w[:, None, None], Jp * w[:, None, None]
    Hcc = segment_sum(plan_c, _products3(Jcw, Jc))
    Hpp = segment_sum(plan_p, _products3(Jpw, Jp))
    gc = segment_sum(plan_c, _products3(Jcw, r[:, :, None])[..., 0])
    gp = segment_sum(plan_p, _products3(Jpw, r[:, :, None])[..., 0])
    B = segment_sum(plan_pc, _products3(Jcw, Jp)).reshape(P, C, 6, 3)
    hub = _huber(chi2, delta2, depth_ok) * prob.edge_valid.to(chi2.dtype)
    return Hcc, Hpp, B, gc, gp, segment_sum(plan_all, hub[:, None])[0, 0]


def reduced_system(S, rhs, cam_free_mask):
    """S [C,C,6,6], rhs [C,6] -> the flat [6C,6C] system and its right-hand
    side, cameras not free held by identity rows."""
    C = S.shape[0]
    Sf = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    mask6 = cam_free_mask.repeat_interleave(6)
    Sf = torch.where(mask6[:, None] & mask6[None, :], Sf, torch.zeros_like(Sf))
    Sf = Sf + torch.diag(torch.where(mask6, 0.0, 1.0).to(Sf.dtype))
    rf = torch.where(mask6, rhs.reshape(-1), torch.zeros_like(rhs.reshape(-1)))
    return Sf, rf


def _cholesky_solve(Sf, rf, C: int):
    """The reduced system by Cholesky in one fixed order (kernel 12b on the
    card, its twin on the CPU): NaN where it is not positive definite."""
    return chol_solve(Sf.contiguous(), rf.contiguous()).reshape(C, 6)


def schur_blocks(Hpp, B, gp, lam, pairs):
    """The point side of the Schur complement of one damping, over the
    observed (point, camera) blocks (`pairs`: ``dense_pairs``): (the damped
    Hpp^-1 [P,3,3], the observed blocks B_o [O,6,3], -B Hpp^-1 B^T
    [C,C,6,6], B Hpp^-1 gp [C,6])."""
    C = B.shape[1]
    obs_p, obs_c, i, j, plan_s, plan_c, _ = pairs
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    Hpp_inv = inv3(_damp_blocks(Hpp, lam) + 1e-8 * eye3)                        # [P,3,3]
    Bo = B[obs_p, obs_c]                                                        # [O,6,3]
    Hi = Hpp_inv[obs_p]
    BH = (Bo[:, :, 0, None] * Hi[:, None, 0, :] + Bo[:, :, 1, None] * Hi[:, None, 1, :]
          + Bo[:, :, 2, None] * Hi[:, None, 2, :])                              # [O,6,3]
    BHi, Bj = BH[i], Bo[j]
    terms = (BHi[:, :, 0, None] * Bj[:, None, :, 0] + BHi[:, :, 1, None] * Bj[:, None, :, 1]
             + BHi[:, :, 2, None] * Bj[:, None, :, 2])                          # [Q,6,6]
    g = gp[obs_p]
    rhs_p = segment_sum(plan_c, dot3(BH[:, :, 0], g[:, 0, None], BH[:, :, 1], g[:, 1, None],
                                     BH[:, :, 2], g[:, 2, None]))               # [C,6]
    return Hpp_inv, Bo, -segment_sum(plan_s, terms).reshape(C, C, 6, 6), rhs_p


def back_substitute(Hpp_inv, Bo, gp, pairs, dc):
    """The points' steps Hpp^-1 (-gp - B^T dc) [P,3] for the camera step dc
    [C,6], over the observed blocks (``schur_blocks``'s)."""
    d = dc[pairs[1]]
    Btdc = segment_sum(pairs[6], sum(Bo[:, k, :] * d[:, k, None] for k in range(6)))   # [P,3]
    rr = -gp - Btdc
    return torch.stack([dot3(Hpp_inv[:, a, 0], rr[:, 0], Hpp_inv[:, a, 1], rr[:, 1],
                             Hpp_inv[:, a, 2], rr[:, 2]) for a in range(3)], dim=1)


def dense_reduced_system(Hcc, Hpp, B, gc, gp, lam, cam_free_mask, pairs):
    """The dense Schur complement of one damping over the observed (point,
    camera) blocks (`pairs`: ``dense_pairs``): (Sf [6C,6C], rf [6C], the
    damped Hpp^-1 [P,3,3], the observed blocks B_o [O,6,3])."""
    C = Hcc.shape[0]
    Hpp_inv, Bo, S, rhs_p = schur_blocks(Hpp, B, gp, lam, pairs)
    ar = torch.arange(C, device=Hcc.device)
    S[ar, ar] += _damp_blocks(Hcc, lam)
    return (*reduced_system(S, rhs_p - gc, cam_free_mask), Hpp_inv, Bo)


def schur_solve_dense(Hcc, Hpp, B, gc, gp, lam, cam_free_mask, pairs=None):
    """Direct dense solve of the Schur-reduced camera system.  Hcc [C,6,6],
    Hpp [P,3,3], B [P,C,6,3], gc [C,6], gp [P,3]; cam_free_mask [C] bool,
    the cameras allowed to move.  Returns (dc [C,6], dp [P,3]).  The sums run
    over the observed (point, camera) blocks only (`pairs`:
    ``dense_pairs``; by default B's nonzero blocks)."""
    C, P = Hcc.shape[0], Hpp.shape[0]
    if pairs is None:
        pc = torch.nonzero(B.reshape(P * C, 18).ne(0).any(1)).flatten()
        pairs = dense_pairs(pc // C, pc % C, C, P)
    Sf, rf, Hpp_inv, Bo = dense_reduced_system(Hcc, Hpp, B, gc, gp, lam, cam_free_mask, pairs)
    dc = _cholesky_solve(Sf, rf, C)
    dc = torch.where(cam_free_mask[:, None], dc, torch.zeros_like(dc))
    return dc, back_substitute(Hpp_inv, Bo, gp, pairs, dc)


def dense_pairs(obs_p, obs_c, C: int, P: int):
    """The dense Schur sums' structure, from the observed (point, camera)
    pairs in (point, camera) order: the pairs of pairs that share a point
    (the S blocks' terms) and kernel 11's plans over them (S by camera pair,
    the right-hand side by camera, B^T dc by point)."""
    cnt = torch.bincount(obs_p, minlength=P)
    first = torch.cumsum(cnt, 0) - cnt
    n = cnt[obs_p]                                      # observers of each pair's point
    i = torch.repeat_interleave(torch.arange(obs_p.shape[0], device=obs_p.device), n)
    block = torch.cumsum(n, 0) - n                      # the first row of each pair's block
    j = first[obs_p][i] + torch.arange(i.shape[0], device=obs_p.device) - block[i]
    return (obs_p, obs_c, i, j, segment_plan(obs_c[i] * C + obs_c[j], C * C),
            segment_plan(obs_c, C), segment_plan(obs_p, P))


def dense_setup(prob: BAProblem):
    """What ``bundle_adjust`` builds once a solve: ``normal_eq_plans`` and
    ``dense_pairs`` over the (point, camera) pairs with a valid edge."""
    C, P = prob.R.shape[0], prob.points.shape[0]
    ok = prob.edge_valid
    pc = torch.unique(prob.pt_idx.long()[ok] * C + prob.cam_idx.long()[ok])      # sorted
    return normal_eq_plans(prob), dense_pairs(pc // C, pc % C, C, P)


def bundle_adjust(cam: CameraModel, prob: BAProblem, iters: int = 10, robust: bool = True,
                  lam0: float = 1e-5):
    """Robust LM bundle adjustment with the dense Schur solve: `iters` LM
    steps with Huber IRLS weights, a step kept when it lowers the cost
    (lambda x 0.3, else x 8).  Returns (R [C,3,3], t [C,3], points [P,3],
    edge_inlier [E] by the final chi2 and depth test, the last step's
    cost).  The card gives the CPU's bits."""
    dev = prob.points.device
    cam_free = prob.cam_valid & ~prob.cam_fixed
    ptv = prob.pt_valid[:, None].to(prob.points.dtype)
    R, t, X = prob.R, prob.t, prob.points
    lam = torch.tensor(lam0, device=dev)
    cost_new = None
    plans, pairs = dense_setup(prob)
    for _ in range(iters):
        Hcc, Hpp, B, gc, gp, cost = build_normal_eqs(cam, prob.replace(R=R, t=t, points=X), robust,
                                                     plans)
        dc, dp = schur_solve_dense(Hcc, Hpp, B, gc, gp, lam, cam_free, pairs)
        del B
        R_new, t_new = lie.se3_retract(R, t, dc)
        X_new = X + dp * ptv
        # the reference rebuilds every block only to read this number
        cost_new = edge_cost(cam, prob.replace(R=R_new, t=t_new, points=X_new), plans[3])
        better = cost_new < cost
        R = torch.where(better, R_new, R)
        t = torch.where(better, t_new, t)
        X = torch.where(better, X_new, X)
        lam = torch.where(better, lam * 0.3, lam * 8.0)
    r, _, _, is_stereo, depth_ok = edge_residual_jac(cam, prob.replace(R=R, t=t, points=X), False)
    inlier = prob.edge_valid & (edge_chi2(r, prob.inv_sigma2) <= _delta2(prob.ur)) & depth_ok
    return R, t, X, inlier, cost_new


def _project_planes(cam, R, t, X, g):
    Xg = X[torch.clamp_min(g.pt_loc, 0).long()]                 # [C,N,3]
    return torch.einsum("cij,cnj->cin", R, Xg) + t[:, :, None]   # [C,3,N]


def _delta2(ur):
    return torch.where(ur >= 0, CHI2_STEREO, CHI2_MONO)


def _huber(chi2, delta2, depth_ok):
    root = via_f64(torch.sqrt, delta2 * torch.clamp_min(chi2, 0.0))
    hub = torch.where(chi2 > delta2, 2.0 * root - delta2, chi2)
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


def schur_system_planes(Hcc, Hpp, B, gc, gp, lam, cam_free_mask):
    """The reduced camera system of one damping: Hcc [C,6,6], Hpp [3,3,P],
    B [6,3,C,P], gc [C,6], gp [3,P] -> (Sf [6C,6C], rf [6C], the damped
    Hpp^-1 [3,3,P])."""
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
    return (*reduced_system(S, rhs, cam_free_mask), Hpp_inv)


def schur_solve_planes(Hcc, Hpp, B, gc, gp, lam, cam_free_mask):
    """Hcc [C,6,6], Hpp [3,3,P], B [6,3,C,P], gc [C,6], gp [3,P] ->
    (dc [C,6], dp [P,3])."""
    C = Hcc.shape[0]
    Sf, rf, Hpp_inv = schur_system_planes(Hcc, Hpp, B, gc, gp, lam, cam_free_mask)
    dc = _cholesky_solve(Sf, rf, C)
    dc = torch.where(cam_free_mask[:, None], dc, torch.zeros_like(dc))
    Btdc = torch.einsum("ikcp,ci->kp", B, dc)
    dp = torch.einsum("jkp,kp->jp", Hpp_inv, -gp - Btdc)
    return dc, dp.T


def grid_inverse_index(g: GridBA):
    """The one-time (point, camera) -> feature inverse index of the grid BA:
    (base_valid [C,N], selT [C,P]: the flat index into a [C, N + 1] plane of
    camera c's lowest valid slot observing p, or of its pad column N)."""
    C, N = g.pt_loc.shape
    P = g.points.shape[0]
    dev = g.points.device
    base_valid = g.edge_valid & (g.pt_loc >= 0)
    cam_ids = torch.arange(C, device=dev)[:, None].expand(C, N)
    n_ids = torch.arange(N, device=dev, dtype=torch.int32)[None, :].expand(C, N)
    lin = torch.clamp_min(g.pt_loc, 0).long() * C + cam_ids
    inv = torch.full((P * C,), N, dtype=torch.int32, device=dev).scatter_reduce(
        0, lin.reshape(-1), torch.where(base_valid, n_ids, N).reshape(-1), "amin").reshape(P, C)
    selT = (inv.long() + torch.arange(C, device=dev)[None, :] * (N + 1)).T      # [C,P]
    return base_valid, selT


def grid_linearize(cam: CameraModel, g: GridBA, R, t, X, robust: bool, base_valid, selT):
    """One linearization of the grid BA at (R, t, X): (Hcc [C,6,6],
    Hpp [3,3,P], B [6,3,C,P], gc [C,6], gp [3,P], the cost over base_valid);
    the point blocks from each (point, camera)'s inverse-index slot only."""

    def take(a):
        ap = torch.nn.functional.pad(a, (0, 1))
        return ap.reshape(a.shape[:-2] + (-1,))[..., selT]

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


def bundle_adjust_grid(cam: CameraModel, g: GridBA, iters: int = 10, robust: bool = True,
                       lam0: float = 1e-5, lam_ladder: tuple = (1.0, 8.0, 64.0)):
    """Robust LM over the [C, N] grid: `iters` iterations, each one
    linearization, a damped Schur solve and a cost for each of lam x
    `lam_ladder`, the first improving try kept.  Returns (R [C,3,3], t [C,3],
    points [P,3], edge_inlier [C,N], cost).  CPU tensors run the plain twin
    (``bundle_adjust_grid_plain``); CUDA tensors launch kernel 12
    (``kernels/grid_ba.grid_ba_solve``) or raise."""
    return grid_ba.grid_ba_solve(cam, g, iters, robust, lam0, lam_ladder)


def bundle_adjust_grid_plain(cam: CameraModel, g: GridBA, iters: int = 10, robust: bool = True,
                             lam0: float = 1e-5, lam_ladder: tuple = (1.0, 8.0, 64.0)):
    """Kernel 12's plain twin.  Returns (R [C,3,3], t [C,3], points [P,3],
    edge_inlier [C,N], cost)."""
    dev = g.points.device
    cam_free = g.cam_valid & ~g.cam_fixed
    base_valid, selT = grid_inverse_index(g)
    R, t, X = g.R, g.t, g.points
    lam = torch.tensor(lam0, device=dev)
    ladder = torch.tensor(lam_ladder, device=dev)
    ptv = g.pt_valid[:, None].to(X.dtype)
    cost_new = None
    for _ in range(iters):
        Hcc, Hpp, B, gc, gp, cost = grid_linearize(cam, g, R, t, X, robust, base_valid, selT)
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
