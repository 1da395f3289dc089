"""The live map's point axis split over the ranks of a ``mesh.Mesh``.

The port's explicit counterpart of what XLA's partitioner does for the
reference's ``shard_map_state``: every ``[P, ...]`` leaf of a MapState is
split cyclically, global point id g living on rank g % n at local row
g // n (the layout of ``dist_ba.shard_ba_problem``), so capacity growth
keeps every point where it is and new points spread over all ranks.
Global ids stay global everywhere else (observations, candidate lists), so
all keyframe state stays replicated.

Each primitive is the plain op it replaces when the mesh is None or has one
rank.  Above one they are built on ``all_reduce`` only (gloo has no CUDA
``all_gather``, and two ranks on one card need gloo), and they are exact:
rows travel as int32 bit patterns, each rank fills what it does not own
with INT32_MIN, and an ``all_reduce(MAX)`` leaves the owner's bits.
INT32_MIN is the pattern of -0.0, so a negative zero survives too, which a
zero-filled sum (``0.0 + -0.0``) would lose.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

INT32_MIN = torch.iinfo(torch.int32).min


def size(mesh) -> int:
    return 1 if mesh is None else mesh.size


def _bits(x: torch.Tensor, lead: int) -> torch.Tensor:
    """x as int32 bit patterns [*x.shape[:lead], w] (float32 viewed, bool cast)."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    elif x.dtype != torch.int32:
        x = x.to(torch.int32)
    return x.reshape(x.shape[:lead] + (-1,))


def _unbits(b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """A tensor of `like`'s dtype and `shape` from bit patterns b, in storage
    of its own (contiguous and at offset 0, as the kernels take them)."""
    out = b.view(torch.float32) if like.dtype == torch.float32 else b.to(like.dtype)
    out = out.reshape(shape)
    return out if out.is_contiguous() and out.storage_offset() == 0 else out.clone(
        memory_format=torch.contiguous_format)


def _max_exchange(mesh, bits: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
    """Every rank's owned entries of `bits` on every rank (own: the leading shape)."""
    bits = torch.where(own[..., None], bits, INT32_MIN).contiguous()
    dist.all_reduce(bits, op=dist.ReduceOp.MAX, group=mesh.group)
    return bits


def all_rows(mesh, *locals_: torch.Tensor) -> tuple:
    """The whole [P, ...] arrays of local [P / n, ...] row blocks, on every rank."""
    n = size(mesh)
    if n == 1:
        return locals_
    Pl = locals_[0].shape[0]
    parts = [_bits(a, 1) for a in locals_]
    bits = torch.cat(parts, 1)
    blk = torch.full((Pl, n, bits.shape[1]), INT32_MIN, dtype=torch.int32, device=bits.device)
    blk[:, mesh.rank] = bits
    dist.all_reduce(blk, op=dist.ReduceOp.MAX, group=mesh.group)
    blk = blk.reshape(Pl * n, -1)
    out, c = [], 0
    for a, p in zip(locals_, parts):
        out.append(_unbits(blk[:, c:c + p.shape[1]], a, (Pl * n,) + a.shape[1:]))
        c += p.shape[1]
    return tuple(out)


def gather_rows(mesh, gid: torch.Tensor, *locals_: torch.Tensor, batch: bool = False) -> tuple:
    """The rows of global ids `gid` (clipped to [0, P - 1], as the port's
    gathers are) of each local array, on every rank, in one exchange.

    locals_: [P / n, ...] arrays, or with `batch` [B, P / n, ...] arrays
    gathered along their second axis by gid [B, k].  A gather of more ids
    than the map has points exchanges the whole arrays instead."""
    n = size(mesh)
    ax = 1 if batch else 0
    Pl = locals_[0].shape[ax]
    g = torch.clamp(gid, 0, Pl * n - 1).long()

    def take(a, rows):
        if batch:
            return a[torch.arange(a.shape[0], device=a.device)[:, None], rows]
        return a[rows]

    if n == 1:
        return tuple(take(a, g) for a in locals_)
    if not batch and g.numel() > Pl * n:
        return tuple(a[g] for a in all_rows(mesh, *locals_))
    own = g % n == mesh.rank
    rows = torch.where(own, g // n, 0)
    picked = [take(a, rows) for a in locals_]
    parts = [_bits(p, g.dim()) for p in picked]
    bits = _max_exchange(mesh, torch.cat(parts, -1), own)
    out, c = [], 0
    for p, b in zip(picked, parts):
        out.append(_unbits(bits[..., c:c + b.shape[-1]], p, p.shape))
        c += b.shape[-1]
    return tuple(out)


def owned_rows(mesh, gid: torch.Tensor, ok: torch.Tensor | None = None):
    """(own, local row): whether this rank holds global id `gid` (and `ok`,
    and gid >= 0), and its local row (0 where not owned)."""
    g = gid.long()
    n = size(mesh)
    own = g >= 0
    if n > 1:
        own = own & (g % n == mesh.rank)
    if ok is not None:
        own = own & ok
    return own, torch.where(own, g // n, 0)


def put_rows(mesh, local: torch.Tensor, gid: torch.Tensor, val, ok: torch.Tensor | None = None):
    """`local` with the rows of the ids in `gid` it owns (where `ok`) set to
    `val`; other ids, -1 ids and the rest go to a dump row.  Owned ids must
    be distinct."""
    own, rows = owned_rows(mesh, gid, ok)
    Pl = local.shape[0]
    tgt = torch.where(own, rows, Pl)
    val = torch.as_tensor(val, dtype=local.dtype, device=local.device)
    return torch.cat([local, local[:1]]).index_put((tgt,), val)[:Pl]


def index_add_rows(mesh, local: torch.Tensor, gid: torch.Tensor, val: torch.Tensor):
    """`local` with `val` added at the rows of the ids in `gid` this rank owns."""
    own, rows = owned_rows(mesh, gid)
    Pl = local.shape[0]
    tgt = torch.where(own, rows, Pl)
    return torch.cat([local, local[:1] * 0]).index_add(0, tgt, val.to(local.dtype))[:Pl]


def scatter_owned(mesh, Pl: int, gid: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """[P / n] bool: the local rows of the ids in `gid` (where `ok`) this rank owns."""
    own, rows = owned_rows(mesh, gid, ok)
    out = torch.zeros(Pl + 1, dtype=torch.int32, device=gid.device)
    out = out.scatter_reduce(0, torch.where(own, rows, Pl).reshape(-1),
                             own.to(torch.int32).reshape(-1), "amax")
    return out[:Pl].bool()


def topk_points(mesh, score: torch.Tensor, k: int):
    """(values, global ids) of the k largest of score [..., P / n] over all
    ranks, highest score first and the lowest id first among ties: exactly
    ``stable_topk`` of the whole [..., P] score.  Each rank's local top
    min(k, P / n) goes into its block of an [..., n, k] exchange, and the
    n blocks are merged by (score descending, id ascending)."""
    from ..ops.sorting import stable_topk

    n = size(mesh)
    if n == 1:
        return stable_topk(score, k)
    Pl = score.shape[-1]
    kl = min(k, Pl)
    v, li = stable_topk(score, kl)
    lead = score.shape[:-1]
    mine = torch.stack([_bits(v, v.dim()).reshape(v.shape), (li * n + mesh.rank).to(torch.int32)],
                       -1)                                                  # [..., kl, 2]
    blk = torch.full(lead + (n, kl, 2), INT32_MIN, dtype=torch.int32, device=score.device)
    blk[..., mesh.rank, :, :] = mine
    dist.all_reduce(blk, op=dist.ReduceOp.MAX, group=mesh.group)
    blk = blk.reshape(lead + (n * kl, 2))
    vals = _unbits(blk[..., 0], v, lead + (n * kl,))
    gids = blk[..., 1].long()
    o = torch.argsort(gids, dim=-1, stable=True)
    vals, gids = torch.gather(vals, -1, o), torch.gather(gids, -1, o)
    vals, o2 = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals[..., :k], torch.gather(gids, -1, o2)[..., :k]


def sum_points(mesh, x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks (counts and booleans: exact)."""
    if size(mesh) == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=mesh.group)
    return x


def any_points(mesh, x: torch.Tensor) -> torch.Tensor:
    """Elementwise OR of a bool tensor over the ranks."""
    if size(mesh) == 1:
        return x
    return sum_points(mesh, x.to(torch.int32)) > 0


def broadcast(mesh, *tensors: torch.Tensor) -> tuple:
    """Rank 0's values of `tensors` on every rank (a replicated solve whose
    summation order is not fixed on the card, so every rank goes on from
    the same bits)."""
    if size(mesh) == 1:
        return tensors
    parts = [_bits(t.contiguous(), 0).reshape(-1) for t in tensors]
    flat = torch.cat(parts)
    dist.broadcast(flat, 0, group=mesh.group)
    out, c = [], 0
    for t, p in zip(tensors, parts):
        out.append(_unbits(flat[c:c + p.numel()], t, t.shape))
        c += p.numel()
    return tuple(out)


def full_map(m):
    """The whole map on every rank (a MapState with no mesh): for saving,
    merging, conversion and the replicated global BA, never on the tracking
    or keyframe path.  A whole map is returned as it is."""
    if m.n_shards == 1:
        return m
    names = [f.name for f in dataclasses.fields(m) if f.name.startswith("mp_")]
    out = m.replace(**dict(zip(names, all_rows(m.mesh, *(getattr(m, k) for k in names)))))
    out.mesh = None
    return out
