"""Sim(3) pose-graph optimization, the essential graph (port of
solvers/pose_graph.py).

7-dof similarity vertices per keyframe; the residual of edge (i, j) with
measurement S_ji is r = log(S_ji S_i S_j^-1) in R^7.  The per-edge Jacobians
are forward mode through the 7-dim tangent retraction, as the reference
takes them (``torch.func.jacfwd``; every edge at once, since edge e's
residual depends only on its own endpoints' tangents).  ``optimize_pose_graph``
solves the dense [7K, 7K] system; ``optimize_pose_graph_cg`` is the
matrix-free block-Jacobi PCG for large K.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry import lie


@dataclasses.dataclass
class PoseGraphProblem:
    """Padded Sim3 pose graph: s [K], R [K,3,3], t [K,3] world->cam; fixed,
    valid [K] bool; edges e_i, e_j [E] with measurements S_ji (e_s [E],
    e_R [E,3,3], e_t [E,3]), e_valid [E] bool, e_weight [E]."""

    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    fixed: torch.Tensor
    valid: torch.Tensor
    e_i: torch.Tensor
    e_j: torch.Tensor
    e_s: torch.Tensor
    e_R: torch.Tensor
    e_t: torch.Tensor
    e_valid: torch.Tensor
    e_weight: torch.Tensor


def edge_measurement(si, Ri, ti, sj, Rj, tj):
    """S_ji = S_j S_i^-1."""
    return lie.sim3_compose(sj, Rj, tj, *lie.sim3_inverse(si, Ri, ti))


def _edge_residual(xi_i, xi_j, Si, Sj, Sji):
    """r = log(S_ji (exp(xi_i) S_i) (exp(xi_j) S_j)^-1) in R^7, batched over edges."""
    si, Ri, ti = lie.sim3_retract(*Si, xi_i)
    sj, Rj, tj = lie.sim3_retract(*Sj, xi_j)
    s1, R1, t1 = lie.sim3_compose(si, Ri, ti, *lie.sim3_inverse(sj, Rj, tj))
    return lie.sim3_log(*lie.sim3_compose(*Sji, s1, R1, t1))


def _edge_poses(prob: PoseGraphProblem, s, R, t):
    """(Si, Sj, Sji, zero tangents [E,7]) of every edge at the current poses."""
    ei, ej = prob.e_i.long(), prob.e_j.long()
    Si, Sj = (s[ei], R[ei], t[ei]), (s[ej], R[ej], t[ej])
    z = torch.zeros((ei.shape[0], 7), dtype=s.dtype, device=s.device)
    return Si, Sj, (prob.e_s, prob.e_R, prob.e_t), z


def _residuals_and_jacs(prob: PoseGraphProblem, s, R, t):
    """(r [E,7], Ji [E,7,7], Jj [E,7,7]) at the current poses."""
    Si, Sj, Sji, z = _edge_poses(prob, s, R, t)
    z7 = torch.zeros(7, dtype=s.dtype, device=s.device)
    r = _edge_residual(z, z, Si, Sj, Sji)
    Ji = torch.func.jacfwd(lambda d: _edge_residual(z + d, z, Si, Sj, Sji))(z7)
    Jj = torch.func.jacfwd(lambda d: _edge_residual(z, z + d, Si, Sj, Sji))(z7)
    return r, Ji, Jj


def _lm_accept(prob, s, R, t, dx, cost, w, lam):
    """Retract by dx; keep the step if it lowers the cost (lambda x 0.3),
    else keep the poses (lambda x 10)."""
    s_n, R_n, t_n = lie.sim3_retract(s, R, t, dx)
    Si, Sj, Sji, z = _edge_poses(prob, s_n, R_n, t_n)
    r2 = _edge_residual(z, z, Si, Sj, Sji)
    better = ((r2 * r2).sum(1) * w).sum() < cost
    return (torch.where(better, s_n, s), torch.where(better, R_n, R), torch.where(better, t_n, t),
            torch.where(better, lam * 0.3, lam * 10.0))


def _scatter_blocks(K, idx, blocks):
    out = torch.zeros((K,) + blocks.shape[1:], dtype=blocks.dtype, device=blocks.device)
    return out.index_add(0, idx, blocks)


def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20, lam0: float = 1e-6):
    """LM over the Sim3 graph with a dense [7K, 7K] solve.  Returns (s, R, t, cost)."""
    K = prob.s.shape[0]
    dev = prob.s.device
    ei, ej = prob.e_i.long(), prob.e_j.long()
    w = prob.e_weight * prob.e_valid
    free = prob.valid & ~prob.fixed
    mask7 = free.repeat_interleave(7)
    s, R, t, lam = prob.s, prob.R, prob.t, torch.tensor(lam0, device=dev)
    cost = torch.zeros((), device=dev)
    for _ in range(iters):
        r, Ji, Jj = _residuals_and_jacs(prob, s, R, t)
        cost = ((r * r).sum(1) * w).sum()
        Jiw, Jjw = Ji * w[:, None, None], Jj * w[:, None, None]
        H = torch.zeros((K * K, 7, 7), device=dev)
        for a, b, Ja, Jb in ((ei, ei, Jiw, Ji), (ej, ej, Jjw, Jj), (ei, ej, Jiw, Jj),
                             (ej, ei, Jjw, Ji)):
            H = H.index_add(0, a * K + b, torch.einsum("eij,eik->ejk", Ja, Jb))
        g = _scatter_blocks(K, ei, torch.einsum("eij,ei->ej", Jiw, r)) \
            + _scatter_blocks(K, ej, torch.einsum("eij,ei->ej", Jjw, r))
        Hf = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        Hf = torch.where(mask7[:, None] & mask7[None, :], Hf, 0.0)
        Hf = Hf + torch.diag(lam * torch.diagonal(Hf) + torch.where(mask7, 1e-8, 1.0))
        gf = torch.where(mask7, g.reshape(-1), 0.0)
        dx = -torch.linalg.solve(Hf, gf).reshape(K, 7)
        dx = torch.where(free[:, None], dx, 0.0)
        s, R, t, lam = _lm_accept(prob, s, R, t, dx, cost, w, lam)
    return s, R, t, cost


def optimize_pose_graph_cg(prob: PoseGraphProblem, iters: int = 20, cg_iters: int = 60,
                           lam0: float = 1e-6):
    """LM over the Sim3 graph with matrix-free block-Jacobi PCG inner solves
    (the normal-equation product assembled edge by edge).  Same returns as
    ``optimize_pose_graph``."""
    K = prob.s.shape[0]
    dev = prob.s.device
    ei, ej = prob.e_i.long(), prob.e_j.long()
    w = prob.e_weight * prob.e_valid
    free = prob.valid & ~prob.fixed
    eye7 = torch.eye(7, device=dev)
    s, R, t, lam = prob.s, prob.R, prob.t, torch.tensor(lam0, device=dev)
    cost = torch.zeros((), device=dev)
    for _ in range(iters):
        r, Ji, Jj = _residuals_and_jacs(prob, s, R, t)
        cost = ((r * r).sum(1) * w).sum()
        Jiw, Jjw = Ji * w[:, None, None], Jj * w[:, None, None]
        g = _scatter_blocks(K, ei, torch.einsum("eij,ei->ej", Jiw, r)) \
            + _scatter_blocks(K, ej, torch.einsum("eij,ei->ej", Jjw, r))
        D = _scatter_blocks(K, ei, torch.einsum("eij,eik->ejk", Jiw, Ji)) \
            + _scatter_blocks(K, ej, torch.einsum("eij,eik->ejk", Jjw, Jj))
        damp = lam * torch.diagonal(D, dim1=-2, dim2=-1) + 1e-8          # [K,7]
        Dinv = torch.linalg.inv(D + damp[:, :, None] * eye7 + eye7 * (~free)[:, None, None])

        def hvp(x):
            u = (torch.einsum("eij,ej->ei", Ji, x[ei]) + torch.einsum("eij,ej->ei", Jj, x[ej])) \
                * w[:, None]
            y = _scatter_blocks(K, ei, torch.einsum("eij,ei->ej", Ji, u)) \
                + _scatter_blocks(K, ej, torch.einsum("eij,ei->ej", Jj, u)) + damp * x
            return torch.where(free[:, None], y, x)

        def m_inv(x):
            return torch.where(free[:, None], torch.einsum("kij,kj->ki", Dinv, x), x)

        b = torch.where(free[:, None], -g, 0.0)
        x = torch.zeros((K, 7), device=dev)
        res, z = b, m_inv(b)
        p, rz = z, (b * z).sum()
        for _ in range(cg_iters):
            Ap = hvp(p)
            denom = (p * Ap).sum()
            alpha = torch.where(denom > 1e-20, rz / denom, 0.0)
            x = x + alpha * p
            res = res - alpha * Ap
            z = m_inv(res)
            rz_new = (res * z).sum()
            beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)
            p = z + beta * p
            rz = rz_new
        dx = torch.where(free[:, None], x, 0.0)
        s, R, t, lam = _lm_accept(prob, s, R, t, dx, cost, w, lam)
    return s, R, t, cost
