"""Distributed bundle adjustment over a process group (port of parallel/dist_ba.py).

The map-point axis is sharded over the ranks of a ``mesh.Mesh``, each point's
observations with it; every rank builds the normal equations of its point
block with the dense ``ba_core.build_normal_eqs`` and ``schur_blocks``, the
camera system (Hcc, gc, the cost, the block's Schur complement and reduced
gradient) is summed over the blocks in block order after one ``all_reduce``
a step, every rank solves the same small camera system (an LU, kernel 12c:
``kernels/lu_solve``), and each updates its own landmark block.  Every step
computes in one order, so the card gives the CPU's bits.  The number of
blocks is the layout's, not the world's: a world of one given the blocks of
n ranks sums the same blocks in the same order and returns their bits.

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
from ..kernels.lu_solve import lu_solve
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


def _sum_blocks(mesh: Mesh, parts, first: int, n_blocks: int):
    """Each tensor of a block's tuple summed over all n_blocks blocks, the
    blocks added in block order.  `parts`: this rank's blocks first,
    first + 1, ...  Each block's tensors fill one row of a [n_blocks, F]
    buffer of zeros, which one all_reduce completes (a row plus +0.0 is the
    row), so the rows, and their sum, do not depend on the world size."""
    rows = torch.stack([torch.cat([t.reshape(-1) for t in p]) for p in parts])
    buf = torch.zeros((n_blocks, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    buf[first:first + len(parts)] += rows
    if mesh.group is not None:
        dist.all_reduce(buf, group=mesh.group)
    acc = buf[0]
    for s in range(1, n_blocks):
        acc = acc + buf[s]
    return tuple(p.reshape(t.shape) for p, t in zip(acc.split([t.numel() for t in parts[0]]),
                                                    parts[0]))


def make_distributed_ba(mesh: Mesh, iters: int = 10, robust: bool = True, lam0: float = 1e-4,
                        live: bool = False, shards: int | None = None):
    """The distributed LM over `mesh`.  Returns fn(cam, prob) -> (R, t,
    points, cost), where every rank passes the same whole problem in the
    ``shard_ba_problem(prob, shards)`` layout and gets back the whole solved
    problem; `shards` (the mesh size by default) is a multiple of the mesh
    size, and each rank takes shards / size consecutive blocks.  The result
    depends on `shards`, not on the mesh size.  With `live`, every rank
    passes its own block (its points, the edges of its points with
    block-local point ids, every camera) and gets back its block's points;
    or, with `shards` above the mesh size, the list of its shards / size
    blocks, and gets back a list."""
    n, me = mesh.size, mesh.rank
    n_blocks = n if shards is None else int(shards)
    if n_blocks % n:
        raise ValueError(f"make_distributed_ba: {n_blocks} blocks over {n} ranks")
    per = n_blocks // n

    def step(cam, prob):
        if live:
            blks = list(prob) if isinstance(prob, (list, tuple)) else [prob]
            if len(blks) != per:
                raise ValueError(f"make_distributed_ba: {len(blks)} live blocks, a rank takes {per}")
            blks = [blk.replace(cam_valid=torch.ones_like(blk.cam_valid)) for blk in blks]
        else:
            blks = [shard_block(prob, n_blocks, me * per + j) for j in range(per)]
        C = blks[0].R.shape[0]
        dev = blks[0].points.device
        free = ~blks[0].cam_fixed
        ptvs = [blk.pt_valid[:, None].to(blk.points.dtype) for blk in blks]
        ar = torch.arange(C, device=dev)
        R, t, Xs = blks[0].R, blks[0].t, [blk.points for blk in blks]
        lam = torch.tensor(lam0, device=dev)
        last_cost = torch.tensor(float("inf"), device=dev)
        setups = [ba_core.dense_setup(blk) for blk in blks]
        for _ in range(iters):
            parts, backs = [], []
            for blk, X, (plans, pairs) in zip(blks, Xs, setups):
                Hcc, Hpp, B, gc, gp, cost = ba_core.build_normal_eqs(
                    cam, blk.replace(R=R, t=t, points=X), robust, plans)
                Hpp_inv, Bo, S_local, rhs_local = ba_core.schur_blocks(Hpp, B, gp, lam, pairs)
                parts.append((Hcc, gc, cost, S_local, rhs_local))
                backs.append((Hpp_inv, Bo, gp, pairs))
            Hcc, gc, cost, S, rhs = _sum_blocks(mesh, parts, me * per, n_blocks)
            S[ar, ar] += ba_core._damp_blocks(Hcc, lam)
            Sf, rf = ba_core.reduced_system(S, rhs - gc, free)
            # an LU, as the reference's jnp.linalg.solve (not the dense path's Cholesky)
            dc = lu_solve(Sf.contiguous(), rf.contiguous()).reshape(C, 6)
            dc = torch.where(free[:, None], dc, torch.zeros_like(dc))
            R_new, t_new = lie.se3_retract(R, t, dc)
            # landmark back-substitution, local to the block
            X_new = [X + ba_core.back_substitute(*back, dc) * ptv
                     for X, ptv, back in zip(Xs, ptvs, backs)]
            # the reference's accept rule, copied for parity (ROADMAP.md §3):
            # `cost` is the cost of the state BEFORE this step, so a step is
            # kept when the point it was taken from beat every earlier one, a
            # step that raised the cost is never reverted, and the cost
            # returned is the lowest seen, not that of the returned state
            better = cost < last_cost
            R = torch.where(better, R_new, R)
            t = torch.where(better, t_new, t)
            Xs = [torch.where(better, Xn, X) for Xn, X in zip(X_new, Xs)]
            lam = torch.where(better, lam * 0.5, lam * 5.0)
            last_cost = torch.minimum(cost, last_cost)
        if live:
            return R, t, (Xs if isinstance(prob, (list, tuple)) else Xs[0]), last_cost
        # every rank's blocks into zeros, summed: the whole point array on
        # each rank (adding zeros is exact)
        Pl = prob.points.shape[0] // n_blocks
        X_all = torch.zeros_like(prob.points)
        X_all[me * per * Pl:(me + 1) * per * Pl] = torch.cat(Xs)
        (X_all,) = _all_reduce(mesh, X_all)
        return R, t, X_all, last_cost

    return step
