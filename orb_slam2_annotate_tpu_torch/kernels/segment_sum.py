"""Kernel 11: a segment sum in one fixed order.

``segment_sum(plan, vals)`` adds the rows of vals [E, ...] f32 into
[S, ...]: out[s] = the sum, in ascending row order from +0.0, of the rows e
with idx[e] == s; rows whose index lies outside [0, S) are dropped (the
dump-row convention).  It launches ``csrc/segment_sum.cu`` for CUDA tensors
and runs the plain twin ``segment_sum_plain`` for CPU tensors;
``segment_sum.launches`` counts kernel launches.

The twin is the CPU's ``index_add``, which adds serially in index order at
any thread count (``np.add.at``'s order, ``tests/test_torch_segment_sum.py``),
so kernel and twin agree bit for bit, and the card gives the same bits on
every run.  A plan (``segment_plan``) is built once a solve: the index sets
stay fixed over the LM iterations.

A caller may also drop the rows it knows to be ±0 by giving them the index
-1 (the solvers' edges of weight 0, whose values are products with +0.0).
That changes no bit: a sum from +0.0 is never -0.0 (two floats sum to -0.0 only
when both are -0.0, and a nonzero exact sum never rounds to 0), and x + ±0
is x for every other x.  It keeps the padded edges, which the solvers
clamp onto row 0, out of one long serial segment.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _build


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """key [E] int64: the row's segment, S for a dropped row; perm [E]
    int32: the rows in ascending (segment, row) order, dropped rows last;
    offsets [S + 1] int32: segment s's rows are perm[offsets[s]:offsets[s + 1]]."""

    key: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    S: int

    @property
    def E(self) -> int:
        return self.key.shape[0]


def segment_plan(idx: torch.Tensor, S: int) -> SegmentPlan:
    """The plan of the index idx [E] (any integer dtype) over S segments:
    a stable sort and the CSR offsets, on idx's device with no host read."""
    idx = idx.reshape(-1).long()
    key = torch.where((idx >= 0) & (idx < S), idx, S)
    sorted_key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(S + 1, dtype=torch.long, device=idx.device)
    offsets = torch.searchsorted(sorted_key, bounds)
    return SegmentPlan(key=key, perm=perm.to(torch.int32), offsets=offsets.to(torch.int32), S=S)


def segment_sum_plain(plan: SegmentPlan, vals: torch.Tensor) -> torch.Tensor:
    """The twin: a serial index_add into S + 1 rows, the last one the dump."""
    out = torch.zeros((plan.S + 1,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add(0, plan.key, vals)[:plan.S]


@functools.cache
def _lib():
    fn = _build.load("segment_sum").segment_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_sum(plan: SegmentPlan, vals: torch.Tensor) -> torch.Tensor:
    """Kernel 11: vals [E, ...] f32 summed into [S, ...] in the plan's order
    (on the card vals is read contiguous: a strided view is copied first)."""
    if not vals.is_cuda:
        return segment_sum_plain(plan, vals)
    vals = vals.contiguous()
    dev = vals.device
    E, S = plan.E, plan.S
    tail = tuple(vals.shape[1:])
    D = math.prod(tail)
    _build.check_tensor(vals, "vals", torch.float32, (E,) + tail, dev)
    _build.check_tensor(plan.perm, "perm", torch.int32, (E,), dev)
    _build.check_tensor(plan.offsets, "offsets", torch.int32, (S + 1,), dev)
    out = torch.empty((S,) + tail, dtype=torch.float32, device=dev)
    err = _lib()(vals.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(), out.data_ptr(),
                 S, D, _build.stream_ptr(dev))
    _build.check_launch(err, "segment_sum")
    if S * D:
        segment_sum.launches += 1
    return out


segment_sum.launches = 0
