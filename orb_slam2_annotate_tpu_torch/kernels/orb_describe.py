"""Kernel 2: a frame's keypoint selection, IC angle and steered BRIEF, from
kernel 1's stacks to the frame's features.

``orb_describe(pyr3, pyr3_blur, score, is_hi, dt, tab)`` launches
``csrc/orb_describe.cu`` for CUDA stacks, two launches on the stream, each
with one warp per cell of every level: stage A takes each cell's winner;
stage B ranks each winner among its level's cells, and the winners that
rank inside the level's budget write their keypoint at their slot and
describe it.  For CPU stacks it runs the plain twin ``orb_describe_plain``:
``ops/select.select_level`` per level, ``describe_keypoints_plain``, the
scale to level 0 and the pad or cut to ``n_features``.  Both return
(xy [N,2] level-0, response, octave, angle, desc [N,16], valid),
N = n_features.  ``describe_tables`` holds the cell geometry of every level
and the kernel's workspace, made once per (H, W, levels, scale,
n_features, device); the BRIEF offsets as linear offsets are made once per
(sampling tables, device, width).  ``orb_describe.launches`` counts the
calls that launched.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import numpy as np
import torch

from ..ops import orb, pyramid, select
from . import _build

MAX_LEVELS = 16
CELLS_PER_CTA = 8      # cells a CTA takes, one a warp, in both stages (csrc/orb_describe.cu)


def describe_keypoints_plain(pyr3: torch.Tensor, pyr3_blur: torch.Tensor, level_hw: torch.Tensor,
                             kps: torch.Tensor, octave: torch.Tensor, valid: torch.Tensor,
                             tab: orb.OrbTables):
    """Stage B's work on given keypoints: pyr3/pyr3_blur [L,H0,W0] zero-padded
    levels, level_hw [L,2] i32, kps [N,2] level coords, octave [N] i32,
    valid [N] bool -> (angle [N] f32, desc [N,16] i32)."""
    oct_l = octave.long()
    hw = level_hw.long()
    patches = orb.keypoint_patches(pyr3, kps, oct_l, hw)
    patches_b = orb.keypoint_patches(pyr3_blur, kps, oct_l, hw, half=tab.brief_half)
    ang = orb.ic_angles_patches(patches, valid, tab)
    return ang, orb.brief_descriptors_patches(patches_b, ang, valid, tab)


class _Level(ctypes.Structure):
    """csrc/orb_describe.cu's Level, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in ("h", "w", "cs", "gw", "n_cells", "cell_base",
                                             "cta_base", "k", "off", "budget")] \
        + [("scale", ctypes.c_float)]


_P = ctypes.c_void_p


class _DescribeArgs(ctypes.Structure):
    """csrc/orb_describe.cu's DescribeArgs, field for field."""

    _fields_ = [("pyr", _P), ("blur", _P), ("score", _P), ("is_hi", _P), ("brief", _P),
                ("cells", _P), ("xy", _P), ("resp", _P), ("octave", _P), ("angle", _P),
                ("desc", _P), ("valid", _P), ("lv", _Level * MAX_LEVELS),
                ("umax", ctypes.c_int * (orb.HALF_PATCH + 1)), ("n_circ", ctypes.c_float),
                ("sum_r2", ctypes.c_float), ("two_pi", ctypes.c_float),
                ("bin_width", ctypes.c_float)] \
        + [(n, ctypes.c_int) for n in ("n_levels", "n_ctas", "total_cells", "max_cells", "H0",
                                       "W0", "brief_half", "n_features")]


@dataclasses.dataclass(frozen=True, eq=False)
class DescribeTables:
    """A frame shape's selection geometry: level l has budget[l] slots from
    off[l], a grid of cells of cell_size[l] pixels, and ranks its cells'
    winners into the first k[l] = min(budget, cells) slots.  ``cells`` is
    stage A's workspace on the device ([3, total cells]: priority, flat
    index and score of each cell's winner); ``args`` holds every constant
    field of the kernel's arguments."""

    lt: pyramid.LevelTables
    n_features: int
    budgets: tuple
    cell_sizes: tuple
    grids: tuple           # (gh, gw) per level
    cells: torch.Tensor
    args: _DescribeArgs


@functools.lru_cache(maxsize=16)
def _describe_tables(height: int, width: int, n_levels: int, scale: float, n_features: int,
                     device: str) -> DescribeTables:
    if n_levels > MAX_LEVELS:
        raise ValueError(f"orb_describe: {n_levels} levels, the kernel takes {MAX_LEVELS}")
    lt = pyramid.level_tables(height, width, n_levels, scale, device)
    budgets = tuple(pyramid.features_per_level(n_features, n_levels, scale))
    a = _DescribeArgs()
    sizes, grids = [], []
    cell_base = cta_base = off = 0
    for l, ((h, w), b) in enumerate(zip(lt.shapes, budgets)):
        cs = select._pick_cell_size(h, w, b)
        gh, gw = h // cs, w // cs
        n = gh * gw
        a.lv[l] = _Level(h, w, cs, gw, n, cell_base, cta_base, min(b, n), off, b,
                         float(np.float32(scale**l)))
        sizes.append(cs)
        grids.append((gh, gw))
        cell_base += n
        cta_base += -(-n // CELLS_PER_CTA)
        off += b
    a.umax[:] = [int(u) for u in orb.circle_umax()]
    a.two_pi = float(np.float32(2.0 * np.pi))
    a.bin_width = float(np.float32(2.0 * np.pi / orb.N_ANGLE_BINS))
    a.n_levels, a.n_ctas, a.total_cells = n_levels, cta_base, cell_base
    a.max_cells = max(g[0] * g[1] for g in grids)
    a.H0, a.W0, a.n_features = height, width, n_features
    cells = torch.empty((3, max(cell_base, 1)), dtype=torch.int32, device=device)
    a.cells = cells.data_ptr()
    return DescribeTables(lt, n_features, budgets, tuple(sizes), tuple(grids), cells, a)


def describe_tables(height: int, width: int, n_levels: int, scale: float, n_features: int,
                    device) -> DescribeTables:
    return _describe_tables(height, width, n_levels, float(scale), n_features,
                            str(torch.device(device)))


def orb_describe_plain(pyr3, pyr3_blur, score, is_hi, dt: DescribeTables, tab: orb.OrbTables):
    """The kernel's function in plain torch: [L,H0,W0] stacks -> (xy [N,2]
    level-0, response [N], octave [N] i32, angle [N], desc [N,16] i32,
    valid [N] bool), N = n_features."""
    lt = dt.lt
    parts = [select.select_level(score[l, :h, :w], is_hi[l, :h, :w], b, l)
             for l, ((h, w), b) in enumerate(zip(lt.shapes, dt.budgets))]
    xy_l, resp, octv, valid = (torch.cat([p[i] for p in parts]) for i in range(4))
    ang, desc = describe_keypoints_plain(pyr3, pyr3_blur, lt.level_hw, xy_l, octv, valid, tab)
    out = [xy_l * lt.scales[octv.long()][:, None], resp, octv, ang, desc, valid]
    n, n_feat = xy_l.shape[0], dt.n_features
    if n < n_feat:
        out = [torch.cat([t, t.new_zeros((n_feat - n, *t.shape[1:]))]) for t in out]
    return tuple(t[:n_feat] for t in out)


@functools.cache
def _lib():
    fn = _build.load("orb_describe").orb_describe_launch
    fn.argtypes = [ctypes.POINTER(_DescribeArgs), _P]
    fn.restype = ctypes.c_int
    return fn


_BRIEF_TABLES: "weakref.WeakKeyDictionary[orb.OrbTables, dict]" = weakref.WeakKeyDictionary()


def _brief_table(tab: orb.OrbTables, dev, width: int) -> torch.Tensor:
    """[N_ANGLE_BINS, N_BITS, 2] int32: each bit pair's p and q sample offsets
    as dy * width + dx, made (and the tables checked) once per (tables,
    device, width)."""
    per_tab = _BRIEF_TABLES.setdefault(tab, {})
    t = per_tab.get((dev, width))
    if t is None:
        _build.check_tensor(tab.rot_offsets, "rot_offsets", torch.int32,
                            (orb.N_ANGLE_BINS, 2 * orb.N_BITS, 2), dev)
        if not torch.equal(tab.circ_mask.cpu(), torch.from_numpy(orb._circular_grids()[2])):
            raise ValueError("orb_describe: the kernel computes the standard circular patch mask")
        lin = tab.rot_offsets[..., 0] * width + tab.rot_offsets[..., 1]
        t = torch.stack([lin[:, :orb.N_BITS], lin[:, orb.N_BITS:]], -1).contiguous()
        per_tab[(dev, width)] = t
    return t


def orb_describe(pyr3, pyr3_blur, score, is_hi, dt: DescribeTables, tab: orb.OrbTables):
    if not pyr3.is_cuda:
        return orb_describe_plain(pyr3, pyr3_blur, score, is_hi, dt, tab)
    dev = pyr3.device
    shape = (len(dt.lt.shapes), dt.args.H0, dt.args.W0)
    for t, name, dtype in ((pyr3, "pyr3", torch.float32), (pyr3_blur, "pyr3_blur", torch.float32),
                           (score, "score", torch.float32), (is_hi, "is_hi", torch.bool)):
        _build.check_tensor(t, name, dtype, shape, dev)
    if dt.cells.device != dev:
        raise ValueError(f"orb_describe: tables on {dt.cells.device}, stacks on {dev}")
    brief = _brief_table(tab, dev, dt.args.W0)
    n = dt.n_features
    xy = torch.empty((n, 2), dtype=torch.float32, device=dev)
    resp = torch.empty((n,), dtype=torch.float32, device=dev)
    octave = torch.empty((n,), dtype=torch.int32, device=dev)
    angle = torch.empty((n,), dtype=torch.float32, device=dev)
    desc = torch.empty((n, orb.DESC_WORDS), dtype=torch.int32, device=dev)
    valid = torch.empty((n,), dtype=torch.bool, device=dev)
    a = dt.args
    a.pyr, a.blur, a.score, a.is_hi = (pyr3.data_ptr(), pyr3_blur.data_ptr(), score.data_ptr(),
                                       is_hi.data_ptr())
    a.brief, a.n_circ, a.sum_r2, a.brief_half = (brief.data_ptr(), tab.n_circ, tab.sum_r2,
                                                 tab.brief_half)
    a.xy, a.resp, a.octave, a.angle, a.desc, a.valid = (
        xy.data_ptr(), resp.data_ptr(), octave.data_ptr(), angle.data_ptr(), desc.data_ptr(),
        valid.data_ptr())
    _build.check_launch(_lib()(ctypes.byref(a), _build.stream_ptr(dev)), "orb_describe")
    orb_describe.launches += 1
    return xy, resp, octave, angle, desc, valid


orb_describe.launches = 0
