"""Kernel 2: IC angle + steered BRIEF for every keypoint of a frame.

``orb_describe`` launches ``csrc/orb_describe.cu`` for CUDA tensors and runs
the plain twin ``orb_describe_plain`` for CPU tensors;
``orb_describe.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import orb
from . import _build


def orb_describe_plain(pyr3: torch.Tensor, pyr3_blur: torch.Tensor, level_hw: torch.Tensor,
                       kps: torch.Tensor, octave: torch.Tensor, valid: torch.Tensor,
                       tab: orb.OrbTables):
    """pyr3/pyr3_blur [L,H0,W0] zero-padded levels, level_hw [L,2] i32,
    kps [N,2] level coords, octave [N] i32, valid [N] bool ->
    (angle [N] f32, desc [N,16] i32)."""
    oct_l = octave.long()
    hw = level_hw.long()
    patches = orb.keypoint_patches(pyr3, kps, oct_l, hw)
    patches_b = orb.keypoint_patches(pyr3_blur, kps, oct_l, hw, half=tab.brief_half)
    ang = orb.ic_angles_patches(patches, valid, tab)
    return ang, orb.brief_descriptors_patches(patches_b, ang, valid, tab)


@functools.cache
def _lib():
    lib = _build.load("orb_describe")
    fn = lib.orb_describe_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] + [ctypes.c_float] * 2 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


_TWO_PI = float(np.float32(2.0 * np.pi))
_BIN_WIDTH = float(np.float32(2.0 * np.pi / orb.N_ANGLE_BINS))


def orb_describe(pyr3, pyr3_blur, level_hw, kps, octave, valid, tab: orb.OrbTables):
    if not pyr3.is_cuda:
        return orb_describe_plain(pyr3, pyr3_blur, level_hw, kps, octave, valid, tab)
    dev = pyr3.device
    L, H0, W0 = pyr3.shape
    N = kps.shape[0]
    for t, name, dt, shape in (
            (pyr3, "pyr3", torch.float32, (L, H0, W0)),
            (pyr3_blur, "pyr3_blur", torch.float32, (L, H0, W0)),
            (level_hw, "level_hw", torch.int32, (L, 2)),
            (kps, "kps", torch.float32, (N, 2)),
            (octave, "octave", torch.int32, (N,)),
            (valid, "valid", torch.bool, (N,)),
            (tab.grid_x, "grid_x", torch.float32, (31, 31)),
            (tab.grid_y, "grid_y", torch.float32, (31, 31)),
            (tab.circ_mask, "circ_mask", torch.float32, (31, 31)),
            (tab.rot_offsets, "rot_offsets", torch.int32, (orb.N_ANGLE_BINS, 2 * orb.N_BITS, 2))):
        _build.check_tensor(t, name, dt, shape, dev)
    angle = torch.empty((N,), dtype=torch.float32, device=dev)
    desc = torch.empty((N, orb.DESC_WORDS), dtype=torch.int32, device=dev)
    err = _lib()(pyr3.data_ptr(), pyr3_blur.data_ptr(), H0, W0, level_hw.data_ptr(),
                 kps.data_ptr(), octave.data_ptr(), valid.data_ptr(), tab.grid_x.data_ptr(),
                 tab.grid_y.data_ptr(), tab.circ_mask.data_ptr(), tab.rot_offsets.data_ptr(),
                 tab.n_circ, tab.sum_r2, tab.brief_half, _TWO_PI, _BIN_WIDTH, N,
                 angle.data_ptr(), desc.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "orb_describe")
    orb_describe.launches += 1
    return angle, desc


orb_describe.launches = 0
