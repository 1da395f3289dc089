"""Kernel 1: a frame's pyramid, blur, FAST-9 score, 3x3 NMS and EDGE margin
for every level, in one launch.

``fast_nms`` launches ``csrc/fast_nms.cu`` for a CUDA image and runs the
plain twin ``fast_nms_frame_plain`` for a CPU image; ``fast_nms.launches``
counts kernel launches.  Both return four [L,H0,W0] stacks, zero outside
each level: (pyr3, pyr3_blur, score, is_hi).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import fast, pyramid
from . import _build


def fast_nms_plain(img: torch.Tensor, thr_lo: float, thr_hi: float, margin: int):
    """One level: img [H,W] f32 -> (score [H,W] f32 after NMS and margin,
    is_hi [H,W] bool)."""
    score, is_hi = fast.fast_score_map(img, thr_lo, thr_hi)
    return fast.margin_mask(fast.nms3x3(score), margin), is_hi


def detect_stack_plain(pyr3: torch.Tensor, lt: pyramid.LevelTables, thr_lo: float,
                       thr_hi: float, margin: int):
    """The kernel's work after the resize, on given levels: pyr3 [L,H0,W0] ->
    (pyr3_blur, score, is_hi) stacks, each level blurred at its own border."""
    blur, score = torch.zeros_like(pyr3), torch.zeros_like(pyr3)
    is_hi = torch.zeros(pyr3.shape, dtype=torch.bool, device=pyr3.device)
    for l, (h, w) in enumerate(lt.shapes):
        lv = pyr3[l, :h, :w]
        blur[l, :h, :w] = pyramid.gaussian_blur(lv)
        score[l, :h, :w], is_hi[l, :h, :w] = fast_nms_plain(lv, thr_lo, thr_hi, margin)
    return blur, score, is_hi


def fast_nms_frame_plain(image: torch.Tensor, lt: pyramid.LevelTables, thr_lo: float,
                         thr_hi: float, margin: int):
    """image [H0,W0] f32 -> (pyr3, pyr3_blur, score, is_hi), each [L,H0,W0]."""
    pyr3 = pyramid.resize_stack(image, lt)
    return (pyr3, *detect_stack_plain(pyr3, lt, thr_lo, thr_hi, margin))


_P = ctypes.c_void_p
_MAXL = 16           # csrc/fast_nms.cu MAXL: levels a launch takes
_TX, _TY = 64, 16    # csrc/fast_nms.cu TX, TY: a tile
_TT = 32             # csrc/fast_nms.cu TT: taps a level may have (at most TCAP, 144)
_PAD_ROWS = 8        # csrc/fast_nms.cu PAD_ROWS: rows of a padding item


class _PyrArgs(ctypes.Structure):
    """csrc/fast_nms.cu's PyrArgs, field for field."""

    _fields_ = [("img", _P), ("row_first", _P), ("row_w", _P),
                ("col_first", _P), ("col_w", _P), ("pyr3", _P), ("blur", _P), ("score", _P),
                ("is_hi", _P), ("k", ctypes.c_float * 7), ("thr_lo", ctypes.c_float),
                ("thr_hi", ctypes.c_float), ("H0", ctypes.c_int), ("W0", ctypes.c_int),
                ("T", ctypes.c_int), ("margin", ctypes.c_int), ("n_levels", ctypes.c_int),
                ("seg", ctypes.c_int * (2 * _MAXL + 1)), ("hw", ctypes.c_int * (2 * _MAXL)),
                ("taps", ctypes.c_int * (2 * _MAXL))]


@functools.cache
def _lib():
    fn = _build.load("fast_nms").fast_nms_launch
    fn.argtypes = [ctypes.POINTER(_PyrArgs), _P]
    fn.restype = ctypes.c_int
    return fn


_BLUR_TAPS = (ctypes.c_float * 7)(*(float(v) for v in pyramid._gaussian_kernel_1d(7, 2.0)))


@functools.lru_cache(maxsize=16)
def _segments(shapes: tuple, H0: int, W0: int):
    """The launch's work items: segment s < L the tiles of level L - 1 - s
    (the top level first: its taps are the most), segment L + l the bands of
    padding rows of level l (none where the level fills the frame); the first
    item of each segment, then the grid size."""
    L = len(shapes)
    counts = [-(-h // _TY) * -(-w // _TX) for h, w in reversed(shapes)]
    counts += [0 if (h, w) == (H0, W0) else -(-H0 // _PAD_ROWS) for h, w in shapes]
    seg = [0]
    for c in counts:
        seg.append(seg[-1] + c)
    return (ctypes.c_int * (2 * _MAXL + 1))(*seg, *([seg[-1]] * (2 * _MAXL - 2 * L)))


@functools.lru_cache(maxsize=16)
def _level_params(shapes: tuple, taps: tuple):
    """Each level's (h, w) and (row, column) taps as the launch's parameters."""
    flat = lambda pairs: (ctypes.c_int * (2 * _MAXL))(*(v for p in pairs for v in p))
    return flat(shapes), flat(taps)


def fast_nms(image: torch.Tensor, lt: pyramid.LevelTables, thr_lo: float, thr_hi: float,
             margin: int):
    if not image.is_cuda:
        return fast_nms_frame_plain(image, lt, thr_lo, thr_hi, margin)
    dev = image.device
    H0, W0 = image.shape
    L = len(lt.shapes)
    _build.check_tensor(image, "image", torch.float32, (H0, W0), dev)
    if lt.row_first.shape != (L, H0) or lt.col_first.shape != (L, W0) or lt.row_w.device != dev:
        raise ValueError(f"fast_nms: level tables for {tuple(lt.row_first.shape)} x "
                         f"{tuple(lt.col_first.shape)[1:]} on {lt.row_w.device}, image "
                         f"{(H0, W0)} on {dev}")
    # the compass pretest needs thr_hi >= thr_lo, and a signed zero may differ
    # from the twin's only where it scores 0: thr_lo >= 0
    if not 0.0 <= thr_lo <= thr_hi:
        raise ValueError(f"fast_nms: thresholds {thr_lo}, {thr_hi}: the kernel needs "
                         f"0 <= thr_lo <= thr_hi")
    if L > _MAXL or lt.row_w.shape[2] > _TT:
        raise ValueError(f"fast_nms: {L} levels of up to {lt.row_w.shape[2]} taps; the kernel "
                         f"takes {_MAXL} levels of {_TT}")
    out = torch.empty((3, L, H0, W0), dtype=torch.float32, device=dev)
    is_hi = torch.empty((L, H0, W0), dtype=torch.bool, device=dev)
    a = _PyrArgs(image.data_ptr(), lt.row_first.data_ptr(), lt.row_w.data_ptr(), lt.col_first.data_ptr(),
                 lt.col_w.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                 is_hi.data_ptr(), _BLUR_TAPS, float(thr_lo), float(thr_hi), H0, W0,
                 lt.row_w.shape[2], int(margin), L, _segments(lt.shapes, H0, W0),
                 *_level_params(lt.shapes, lt.taps))
    _build.check_launch(_lib()(ctypes.byref(a), _build.stream_ptr(dev)), "fast_nms")
    fast_nms.launches += 1
    return out[0], out[1], out[2], is_hi


fast_nms.launches = 0
