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
stay fixed over the LM iterations.  It checks its tensors once, so a call
checks only ``vals``; the kernel's split into tiles and stages follows
from E, S and D, which the host knows, and reads nothing back.

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

# the launch's shape, mirrored by csrc/segment_sum.cu (NS) and by the CPU
# tests' walk of the schedule.  The walk for at most WALK_ROWS rows a
# segment on average and at most WALK_ITEMS chains; else tiles of G
# consecutive segments, about TARGET_TILES of them (4 CTAs on each of the
# H100's 132 SMs: one wave), at most MAX_G; their stages of at most
# STAGE_BYTES of rows, MAX_STAGE_ROWS rows and the plan's row hint, NS of
# them in the ring
NS = 3
TARGET_TILES = 4 * 132
MAX_G = 2048
STAGE_BYTES = 49152
MAX_STAGE_ROWS = 1024
MIN_ROW_HINT = 32
WALK_ROWS, WALK_ITEMS = 32, 1 << 22
MAX_D = 8192                 # NS rows of D floats must fit in shared memory


class _CPlan(ctypes.Structure):
    """csrc/segment_sum.cu's SegPlan: the plan's device arrays and sizes."""
    _fields_ = [("perm", ctypes.c_void_p), ("offsets", ctypes.c_void_p),
                ("S", ctypes.c_longlong), ("G", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """key [E] int64: the row's segment, S for a dropped row; perm [E]
    int32: the rows in ascending (segment, row) order, dropped rows last;
    offsets [S + 1] int32: segment s's rows are perm[offsets[s]:offsets[s + 1]].
    The kernel walks each segment's rows from global memory for rows of at
    most ``walk_d`` floats (``walk_width``), or else takes tiles of G
    consecutive segments (``tile_width``) in stages of at most ``hint`` rows
    (``row_hint``).  The tensors are checked once, here."""

    key: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    S: int
    G: int = dataclasses.field(init=False)
    hint: int = dataclasses.field(init=False)
    walk_d: int = dataclasses.field(init=False)
    _c: int = dataclasses.field(init=False, repr=False, compare=False)
    _index: int = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        E, dev = self.key.shape[0], self.key.device
        if not (0 <= self.S < 2**31 - 1 and E < 2**31):
            raise ValueError(f"segment_plan: S = {self.S} and E = {E} must fit int32")
        _build.check_tensor(self.key, "key", torch.int64, (E,), dev)
        _build.check_tensor(self.perm, "perm", torch.int32, (E,), dev)
        _build.check_tensor(self.offsets, "offsets", torch.int32, (self.S + 1,), dev)
        object.__setattr__(self, "G", tile_width(self.S))
        object.__setattr__(self, "hint", row_hint(E, self.S))
        object.__setattr__(self, "walk_d", walk_width(E, self.S))
        c = _CPlan(self.perm.data_ptr(), self.offsets.data_ptr(), self.S, self.G)
        object.__setattr__(self, "_cplan", c)           # kept alive with the plan
        object.__setattr__(self, "_c", ctypes.addressof(c))
        object.__setattr__(self, "_index", self.key.get_device())

    @property
    def E(self) -> int:
        return self.key.shape[0]

    @property
    def device(self) -> torch.device:
        return self.key.device


def walk_width(E: int, S: int) -> int:
    """The kernel's path for E rows (the dropped ones included) over S
    segments: the walk (a thread a chain, its rows read from global memory)
    for rows of at most this many floats, the staged tiles for wider rows.
    The walk takes short segments, at most WALK_ROWS rows a segment on
    average, with at most WALK_ITEMS chains; the tiles take long segments
    (a camera's) and the larger outputs, mostly zeros (B), which they
    write as 16-byte stores.  0: the tiles at any width."""
    return WALK_ITEMS // S if 0 < S and E <= WALK_ROWS * S else 0


def tile_width(S: int) -> int:
    """G: the segments of a tile, so that S segments make about TARGET_TILES."""
    return min(MAX_G, max(1, -(-S // TARGET_TILES)))


def row_hint(E: int, S: int) -> int:
    """The rows a stage should hold for a plan of E rows over S segments:
    half a tile's rows were every row kept (the solvers keep a fifth to a
    half), or a mean segment (a camera), at least MIN_ROW_HINT."""
    G = tile_width(S)
    return max(MIN_ROW_HINT, -(-E * G // max(2 * S, 1)), min(-(-E // max(S, 1)), MAX_STAGE_ROWS))


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
def stage_rows(D: int, hint: int) -> int:
    """R, the rows of a stage of the kernel's ring for rows of D floats."""
    return max(1, min(STAGE_BYTES // (4 * D), MAX_STAGE_ROWS, hint))


def check_vals(plan: SegmentPlan, vals: torch.Tensor) -> int:
    """What a launch takes of vals (the plan was checked when built): f32,
    [E, ...] on the plan's device, at most MAX_D floats a row.  One fused
    test passes a good tensor; the separate tests run only to name what
    failed.  Returns D."""
    shape = vals.shape
    if (vals.dtype is torch.float32 and shape and shape[0] == plan.E
            and vals.get_device() == plan._index):
        D = math.prod(shape[1:])
        if D <= MAX_D:
            return D
        raise ValueError(f"vals: {D} floats a row, at most {MAX_D}")
    if vals.dtype is not torch.float32:
        raise TypeError(f"vals: expected torch.float32, got {vals.dtype}")
    if not shape or shape[0] != plan.E:
        raise ValueError(f"vals: expected {plan.E} rows, got shape {tuple(shape)}")
    raise ValueError(f"vals: on {vals.device}, the plan on {plan.device}")


@functools.cache
def _lib():
    fn = _build.load("segment_sum").segment_sum_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def segment_sum(plan: SegmentPlan, vals: torch.Tensor) -> torch.Tensor:
    """Kernel 11: vals [E, ...] f32 summed into [S, ...] in the plan's order
    (on the card vals is read contiguous: a strided view is copied first)."""
    if not vals.is_cuda:
        return segment_sum_plain(plan, vals)
    D = check_vals(plan, vals)
    vals = vals.contiguous()
    out = vals.new_empty((plan.S, *vals.shape[1:]))
    if plan.S and D:
        _build.check_launch(_lib()(plan._c, vals.data_ptr(), out.data_ptr(), D,
                                   0 if D <= plan.walk_d else stage_rows(D, plan.hint),
                                   torch._C._cuda_getCurrentRawStream(plan._index)),
                            "segment_sum")
        segment_sum.launches += 1
    return out


segment_sum.launches = 0
