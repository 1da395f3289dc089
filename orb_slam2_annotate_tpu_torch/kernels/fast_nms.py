"""Kernel 1: FAST-9 score + 3x3 NMS + EDGE margin for one pyramid level.

``fast_nms`` launches ``csrc/fast_nms.cu`` for a CUDA tensor and runs the
plain twin ``fast_nms_plain`` for a CPU tensor; ``fast_nms.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import fast
from . import _build


def fast_nms_plain(img: torch.Tensor, thr_lo: float, thr_hi: float, margin: int):
    """img [H,W] f32 -> (score [H,W] f32 after NMS and margin, is_hi [H,W] bool)."""
    score, is_hi = fast.fast_score_map(img, thr_lo, thr_hi)
    return fast.margin_mask(fast.nms3x3(score), margin), is_hi


@functools.cache
def _lib():
    lib = _build.load("fast_nms")
    fn = lib.fast_nms_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 \
        + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fast_nms(img: torch.Tensor, thr_lo: float, thr_hi: float, margin: int):
    if not img.is_cuda:
        return fast_nms_plain(img, thr_lo, thr_hi, margin)
    H, W = img.shape
    _build.check_tensor(img, "img", torch.float32, (H, W), img.device)
    score = torch.empty((H, W), dtype=torch.float32, device=img.device)
    is_hi = torch.empty((H, W), dtype=torch.bool, device=img.device)
    err = _lib()(img.data_ptr(), score.data_ptr(), is_hi.data_ptr(), H, W,
                 float(thr_lo), float(thr_hi), int(margin), _build.stream_ptr(img.device))
    _build.check_launch(err, "fast_nms")
    fast_nms.launches += 1
    return score, is_hi


fast_nms.launches = 0
