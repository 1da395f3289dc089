"""Matrix-free global bundle adjustment (port of solvers/ba_cg.py).

Robust LM whose inner solve is conjugate gradients on the Schur complement
S x = Hcc x - B Hpp^-1 B^T x, evaluated edge by edge (two segment sums
through the point blocks), with a block-Jacobi camera preconditioner.
Nothing larger than per-edge arrays and [C,6,6] / [P,3,3] blocks is built.
Plain torch; loop closing runs it once a closure.
"""

from __future__ import annotations

import torch

from ..geometry import lie
from ..geometry.smallsolve import inv3
from .ba_core import CHI2_MONO, CHI2_STEREO, BAProblem, _damp_blocks, edge_chi2, edge_residual_jac


def _edge_weights(prob: BAProblem, r, is_stereo, depth_ok):
    """(Huber IRLS weights [E], Huberized cost 0-d)."""
    chi2 = edge_chi2(r, prob.inv_sigma2)
    delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    w_h = torch.where(chi2 > delta2,
                      torch.sqrt(delta2 / torch.clamp_min(chi2, 1e-12)), 1.0)
    w = prob.inv_sigma2 * w_h * (prob.edge_valid & depth_ok)
    hub = torch.where(chi2 > delta2, 2.0 * torch.sqrt(delta2 * torch.clamp_min(chi2, 0.0)) - delta2,
                      chi2)
    hub = torch.where(depth_ok, hub, 100.0 * delta2)
    return w, torch.sum(hub * prob.edge_valid)


def _segment_sum(n, idx, vals):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add(0, idx, vals)


def bundle_adjust_cg(cam, prob: BAProblem, iters: int = 10, cg_iters: int = 30, lam0: float = 1e-5):
    """LM with Schur-PCG inner solves.  Returns (R [C,3,3], t [C,3],
    points [P,3], edge_inlier [E], cost)."""
    C, P = prob.R.shape[0], prob.points.shape[0]
    dev = prob.points.device
    cam_free = prob.cam_valid & ~prob.cam_fixed
    cf = cam_free[:, None].to(torch.float32)
    ci, pi = prob.cam_idx.long(), prob.pt_idx.long()
    eye3, eye6 = torch.eye(3, device=dev), torch.eye(6, device=dev)
    R, t, X = prob.R, prob.t, prob.points
    lam = torch.tensor(lam0, device=dev)
    cost_new = torch.zeros((), device=dev)
    for _ in range(iters):
        r, Jc, Jp, is_stereo, depth_ok = edge_residual_jac(cam, prob.replace(R=R, t=t, points=X))
        w, cost = _edge_weights(prob, r, is_stereo, depth_ok)
        Jc = torch.where((prob.cam_fixed | ~cam_free)[ci][:, None, None], 0.0, Jc)
        Jcw, Jpw = Jc * w[:, None, None], Jp * w[:, None, None]
        Hcc = _segment_sum(C, ci, torch.einsum("eij,eik->ejk", Jcw, Jc))
        Hpp = _segment_sum(P, pi, torch.einsum("eij,eik->ejk", Jpw, Jp))
        gc = _segment_sum(C, ci, torch.einsum("eij,ei->ej", Jcw, r))
        gp = _segment_sum(P, pi, torch.einsum("eij,ei->ej", Jpw, r))
        Hcc_d = _damp_blocks(Hcc, lam)
        Hpp_inv = inv3(_damp_blocks(Hpp, lam) + 1e-8 * eye3)
        Mc_inv = torch.linalg.inv(Hcc_d + 1e-6 * eye6)

        def Bt_x(x):
            u = torch.einsum("eij,ei->ej", Jpw, torch.einsum("eij,ej->ei", Jc, x[ci]))
            return _segment_sum(P, pi, u)

        def B_v(v):
            z = torch.einsum("eij,ei->ej", Jcw, torch.einsum("eij,ej->ei", Jp, v[pi]))
            return _segment_sum(C, ci, z)

        def S_mv(x):
            v = torch.einsum("pij,pj->pi", Hpp_inv, Bt_x(x))
            return torch.einsum("cij,cj->ci", Hcc_d, x) - B_v(v)

        def M_inv(x):
            return torch.einsum("cij,cj->ci", Mc_inv, x) * cf

        rhs = (-gc + B_v(torch.einsum("pij,pj->pi", Hpp_inv, gp))) * cf
        x = torch.zeros((C, 6), device=dev)
        res = rhs
        z = M_inv(rhs)
        d = z
        for _ in range(cg_iters):
            Sd = S_mv(d) * cf
            dSd = (d * Sd).sum()
            rz = (res * z).sum()
            alpha = torch.where(dSd.abs() > 1e-12, rz / dSd, 0.0)
            x = x + alpha * d
            res2 = res - alpha * Sd
            z2 = M_inv(res2)
            beta = torch.where(rz > 1e-12, (res2 * z2).sum() / rz, 0.0)
            d = z2 + beta * d
            res, z = res2, z2
        dc = x * cf
        dp = torch.einsum("pij,pj->pi", Hpp_inv, -gp - Bt_x(dc))
        R_n, t_n = lie.se3_retract(R, t, dc)
        X_n = X + dp * prob.pt_valid[:, None]
        r2, _, _, st2, dok2 = edge_residual_jac(cam, prob.replace(R=R_n, t=t_n, points=X_n))
        _, cost_new = _edge_weights(prob, r2, st2, dok2)
        better = cost_new < cost
        R = torch.where(better, R_n, R)
        t = torch.where(better, t_n, t)
        X = torch.where(better, X_n, X)
        lam = torch.where(better, lam * 0.3, lam * 8.0)
    r, _, _, is_stereo, depth_ok = edge_residual_jac(cam, prob.replace(R=R, t=t, points=X))
    chi2 = edge_chi2(r, prob.inv_sigma2)
    inlier = prob.edge_valid & (chi2 <= torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)) & depth_ok
    return R, t, X, inlier, cost_new
