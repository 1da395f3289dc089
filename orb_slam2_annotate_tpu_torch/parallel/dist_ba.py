"""Distributed bundle adjustment over a process group (port of parallel/dist_ba.py).

The map-point axis is sharded over the ranks of a ``mesh.Mesh``, each point's
observations with it; every rank builds the normal equations of its point
block with the dense ``ba_core.build_normal_eqs``, the camera system (Hcc,
gc, the cost, the block's Schur complement and reduced gradient) is summed
over the group in one packed ``all_reduce`` a step, every rank solves the
same small camera system, and each updates its own landmark block.

Layout contract (``shard_ba_problem``): edges are grouped so that the edges
of point p live on p's shard; cameras are replicated.  A map whose point
axis is already split over the mesh (parallel/points.py, the same cyclic
layout) needs no re-layout: each rank passes its live block as it stands
(``make_distributed_ba(..., live=True)``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..geometry import lie
from ..solvers import ba_core
from ..solvers.ba_core import BAProblem
from .mesh import Mesh


def shard_ba_problem(prob: BAProblem, n_shards: int, return_perm: bool = False):
    """Host-side re-layout: points round-robin into n_shards contiguous
    blocks (point p to shard p % n at local rank p // n), edges grouped by
    their point's shard with invalid edges dropped, both axes padded to a
    multiple of n_shards (padded edges: ur = -1, inv_sigma2 = 1, invalid).
    ``pt_idx`` is the new global point index.  With return_perm=True also
    returns new_index_of_pt [P_orig] (numpy), to un-permute solved points."""
    dev = prob.points.device
    P_tot = prob.points.shape[0]
    E_tot = prob.cam_idx.shape[0]
    pt_np = prob.pt_idx.cpu().numpy()
    ev_np = prob.edge_valid.cpu().numpy()

    P_pad = ((P_tot + n_shards - 1) // n_shards) * n_shards
    per_shard_p = P_pad // n_shards
    pr = np.arange(P_pad)
    new_index_of_pt = (pr % n_shards) * per_shard_p + pr // n_shards

    def reorder_points(arr, fill):
        src = arr.cpu().numpy()
        out = np.full((P_pad,) + src.shape[1:], fill, src.dtype)
        out[new_index_of_pt[:P_tot]] = src
        return out

    new_pt_idx = new_index_of_pt[pt_np]
    shard_of_edge = (new_pt_idx // per_shard_p).astype(np.int64)
    shard_of_edge[~ev_np] = n_shards  # invalid edges last
    order = np.argsort(shard_of_edge, kind="stable")
    counts_all = np.bincount(shard_of_edge[order], minlength=n_shards + 1)
    per_shard_e = max(int(counts_all[:n_shards].max()), 1)
    E_pad = per_shard_e * n_shards
    # sorted edge k of shard s lands at s * per_shard_e + (k - first k of s)
    cum = np.concatenate([[0], np.cumsum(counts_all)])
    sh_sorted = shard_of_edge[order]
    rank = np.arange(E_tot) - cum[sh_sorted]
    live = sh_sorted < n_shards
    dst = (sh_sorted * per_shard_e + rank)[live]
    src_sel = order[live]

    def take_edges(src, fill):
        out = np.full((E_pad,) + src.shape[1:], fill, src.dtype)
        out[dst] = src[src_sel]
        return out

    edges = dict(cam_idx=take_edges(prob.cam_idx.cpu().numpy(), 0),
                 pt_idx=take_edges(new_pt_idx.astype(np.int32), 0),
                 uv=take_edges(prob.uv.cpu().numpy(), 0.0),
                 ur=take_edges(prob.ur.cpu().numpy(), -1.0),
                 inv_sigma2=take_edges(prob.inv_sigma2.cpu().numpy(), 1.0),
                 edge_valid=take_edges(ev_np, False))
    out = prob.replace(points=torch.from_numpy(reorder_points(prob.points, 0.0)).to(dev),
                       pt_valid=torch.from_numpy(reorder_points(prob.pt_valid, False)).to(dev),
                       **{k: torch.from_numpy(v).to(dev) for k, v in edges.items()})
    if return_perm:
        return out, new_index_of_pt[:P_tot]
    return out


def shard_block(prob: BAProblem, n: int, s: int) -> BAProblem:
    """Shard `s` of the n in a ``shard_ba_problem`` layout: its points, its
    edges with block-local point ids, every camera (all valid: the fixed
    mask holds the rest).  A padded edge points outside the block; its id
    is clamped into it (it weighs nothing: the reference's scatter drops
    it)."""
    Pl, El = prob.points.shape[0] // n, prob.cam_idx.shape[0] // n
    ps, es = slice(s * Pl, (s + 1) * Pl), slice(s * El, (s + 1) * El)
    return BAProblem(R=prob.R, t=prob.t, points=prob.points[ps], cam_fixed=prob.cam_fixed,
                     cam_valid=torch.ones_like(prob.cam_valid), pt_valid=prob.pt_valid[ps],
                     cam_idx=prob.cam_idx[es],
                     pt_idx=torch.clamp(prob.pt_idx[es] - s * Pl, 0, Pl - 1), uv=prob.uv[es],
                     ur=prob.ur[es], inv_sigma2=prob.inv_sigma2[es],
                     edge_valid=prob.edge_valid[es])


def _all_reduce(mesh: Mesh, *tensors):
    """The sum of each tensor over the mesh, in one packed all_reduce."""
    if mesh.group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    return tuple(p.reshape(t.shape) for p, t in zip(flat.split([t.numel() for t in tensors]),
                                                     tensors))


def make_distributed_ba(mesh: Mesh, iters: int = 10, robust: bool = True, lam0: float = 1e-4,
                        live: bool = False):
    """The distributed LM over `mesh` (one rank a shard).  Returns
    fn(cam, prob) -> (R, t, points, cost), where every rank passes the same
    whole problem in the ``shard_ba_problem`` layout (point and edge axes
    divisible by the mesh size) and gets back the whole solved problem.
    With `live`, every rank passes its own block (its points, the edges of
    its points with block-local point ids, every camera) and gets back its
    block's points."""
    n, me = mesh.size, mesh.rank

    def step(cam, prob: BAProblem):
        C = prob.R.shape[0]
        dev = prob.points.device
        if live:
            blk = prob.replace(cam_valid=torch.ones_like(prob.cam_valid))
        else:
            blk = shard_block(prob, n, me)
        free = ~prob.cam_fixed
        ptv = blk.pt_valid[:, None].to(blk.points.dtype)
        ar = torch.arange(C, device=dev)
        R, t, X = prob.R, prob.t, blk.points
        lam = torch.tensor(lam0, device=dev)
        last_cost = torch.tensor(float("inf"), device=dev)
        plans = ba_core.normal_eq_plans(blk)
        for _ in range(iters):
            Hcc, Hpp, B, gc, gp, cost = ba_core.build_normal_eqs(
                cam, blk.replace(R=R, t=t, points=X), robust, plans)
            Hpp_inv, S_local, rhs_local = ba_core.schur_terms(Hpp, B, gp, lam)
            Hcc, gc, cost, S, rhs = _all_reduce(mesh, Hcc, gc, cost, S_local, rhs_local)
            S[ar, ar] += ba_core._damp_blocks(Hcc, lam)
            Sf, rf = ba_core.reduced_system(S, rhs - gc, free)
            # an LU, as the reference's jnp.linalg.solve (not the dense path's Cholesky)
            dc = torch.linalg.solve_ex(Sf, rf)[0].reshape(C, 6)
            dc = torch.where(free[:, None], dc, torch.zeros_like(dc))
            # landmark back-substitution, local to the rank
            Btdc = torch.einsum("pcij,ci->pj", B, dc)
            dp = torch.einsum("pij,pj->pi", Hpp_inv, -gp - Btdc)
            R_new, t_new = lie.se3_retract(R, t, dc)
            X_new = X + dp * ptv
            # the reference's accept rule, copied for parity (ROADMAP.md §3):
            # `cost` is the cost of the state BEFORE this step, so a step is
            # kept when the point it was taken from beat every earlier one, a
            # step that raised the cost is never reverted, and the cost
            # returned is the lowest seen, not that of the returned state
            better = cost < last_cost
            R = torch.where(better, R_new, R)
            t = torch.where(better, t_new, t)
            X = torch.where(better, X_new, X)
            lam = torch.where(better, lam * 0.5, lam * 5.0)
            last_cost = torch.minimum(cost, last_cost)
        if live:
            return R, t, X, last_cost
        # every rank's block into zeros, summed: the whole point array on
        # each rank (adding zeros is exact)
        Pl = prob.points.shape[0] // n
        X_all = torch.zeros_like(prob.points)
        X_all[me * Pl:(me + 1) * Pl] = X
        (X_all,) = _all_reduce(mesh, X_all)
        return R, t, X_all, last_cost

    return step
