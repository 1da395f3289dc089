"""Oriented binary descriptors: IC angle + steered BRIEF (port of ops/orb.py).

The sampling pattern is ``brief_pattern.npy`` beside this module, a
byte-identical copy of the reference's asset (tests/test_torch_system.py
checks it), read by file path with numpy.  The
functions below are the plain twins of the ``orb_describe`` CUDA kernel
(kernels/orb_describe.py).

A descriptor bit is the direct compare ``p < q`` of two blurred pixels.
The reference evaluates it as the sign of a +-1 matmul at HIGHEST
precision, which is exactly ``fl(q - p)``, so the two agree bit for bit;
the [32, 1369, 512] matmul table was a TPU matrix-unit device and is not
ported.  Descriptor words are int32 bit patterns of the reference's uint32.
"""

from __future__ import annotations

import os

import numpy as np
import torch

HALF_PATCH = 15
N_BITS = 512
DESC_WORDS = N_BITS // 32
N_ANGLE_BINS = 32

PATTERN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "brief_pattern.npy")


def load_pattern() -> np.ndarray:
    """The learned [N_BITS, 4] (py, px, qy, qx) sampling pattern."""
    pat = np.load(PATTERN_PATH)
    if pat.shape != (N_BITS, 4):
        raise ValueError(f"{PATTERN_PATH}: expected ({N_BITS}, 4), got {pat.shape}")
    return pat.astype(np.int32)


def rotated_offsets(pattern: np.ndarray) -> np.ndarray:
    """[B, 2*N_BITS, 2] (dy, dx) nearest-pixel steered pattern offsets."""
    pat = pattern.astype(np.float64)
    pts = np.concatenate([pat[:, 0:2], pat[:, 2:4]], axis=0)
    out = np.zeros((N_ANGLE_BINS, 2 * N_BITS, 2), np.int32)
    for b in range(N_ANGLE_BINS):
        a = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        out[b, :, 0] = np.round(sa * pts[:, 1] + ca * pts[:, 0])
        out[b, :, 1] = np.round(ca * pts[:, 1] - sa * pts[:, 0])
    return out


def circle_umax() -> np.ndarray:
    """[HALF_PATCH + 1] int32: the patch circle's half-width at row offset |dy|."""
    v = np.arange(HALF_PATCH + 1)
    return np.floor(np.sqrt(np.maximum(HALF_PATCH**2 - v**2, 0)) + 0.5).astype(np.int32)


def _circular_grids():
    umax = circle_umax()
    Y, X = np.mgrid[-HALF_PATCH: HALF_PATCH + 1, -HALF_PATCH: HALF_PATCH + 1]
    circ = (np.abs(X) <= umax[np.abs(Y)]).astype(np.float32)
    return X.astype(np.float32) * circ, Y.astype(np.float32) * circ, circ


class OrbTables(torch.nn.Module):
    """Sampling tables as registered buffers, so ``.to(device)`` moves them."""

    def __init__(self, rot_offsets: np.ndarray | None = None):
        super().__init__()
        gx, gy, cm = _circular_grids()
        if rot_offsets is None:
            rot_offsets = rotated_offsets(load_pattern())
        self.register_buffer("grid_x", torch.from_numpy(gx))
        self.register_buffer("grid_y", torch.from_numpy(gy))
        self.register_buffer("circ_mask", torch.from_numpy(cm))
        self.register_buffer("rot_offsets",
                             torch.from_numpy(np.ascontiguousarray(rot_offsets, np.int32)))
        self.sum_r2 = float(np.sum(gx**2 + gy**2))
        self.n_circ = float(np.sum(cm))
        self.brief_half = int(np.abs(rot_offsets).max())


def keypoint_patches(pyr3d: torch.Tensor, kps: torch.Tensor, octave: torch.Tensor,
                     level_hw: torch.Tensor, half: int = HALF_PATCH) -> torch.Tensor:
    """[N, 2h+1, 2h+1] patches around level keypoints from a padded [L,H0,W0]
    pyramid; centers are clipped to [half, size-half-1] per level."""
    hs = level_hw[octave, 0]
    ws = level_hw[octave, 1]
    x0 = torch.minimum(torch.clamp_min(torch.round(kps[:, 0]).long(), half), ws - half - 1)
    y0 = torch.minimum(torch.clamp_min(torch.round(kps[:, 1]).long(), half), hs - half - 1)
    r = torch.arange(-half, half + 1, device=kps.device)
    yy = (y0[:, None] + r)[:, :, None]
    xx = (x0[:, None] + r)[:, None, :]
    return pyr3d[octave[:, None, None], yy, xx]


def ic_angles_patches(patches: torch.Tensor, valid: torch.Tensor, tab: OrbTables) -> torch.Tensor:
    """Intensity-centroid angles from [N, 31, 31] patches (0 where weak)."""
    p = patches.reshape(patches.shape[0], -1)
    gx = tab.grid_x.reshape(1, -1)
    gy = tab.grid_y.reshape(1, -1)
    cm = tab.circ_mask.reshape(1, -1)
    m10 = torch.sum(p * gx, dim=1)
    m01 = torch.sum(p * gy, dim=1)
    n = torch.sum(cm)
    mu = torch.sum(p * cm, dim=1) / n
    var = torch.sum((p - mu[:, None]) ** 2 * cm, dim=1) / n
    mag2 = m10 * m10 + m01 * m01
    strong = mag2 > 4.0 * var * tab.sum_r2
    return torch.where(valid & strong, torch.atan2(m01, m10), torch.zeros_like(m10))


def angle_bins(angles: torch.Tensor) -> torch.Tensor:
    two_pi = 2.0 * np.pi
    return torch.round(torch.remainder(angles, two_pi) / (two_pi / N_ANGLE_BINS)
                       ).long() % N_ANGLE_BINS


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, N_BITS] bool -> [N, DESC_WORDS] int32, little-endian in each word.
    Packed in int64 and wrapped, so bit 31 never overflows."""
    n = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    w = (bits.reshape(n, DESC_WORDS, 32).long() << shifts).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def brief_descriptors_patches(patches_blur: torch.Tensor, angles: torch.Tensor,
                              valid: torch.Tensor, tab: OrbTables) -> torch.Tensor:
    """Steered BRIEF from [N, 2B+1, 2B+1] blurred patches: bit k = p < q at
    the angle bin's rotated sample offsets."""
    n, side = patches_blur.shape[0], patches_blur.shape[1]
    c = side // 2
    off = tab.rot_offsets[angle_bins(angles)].long()            # [N, 2*N_BITS, 2]
    lin = (off[..., 0] + c) * side + off[..., 1] + c
    vals = torch.gather(patches_blur.reshape(n, -1), 1, lin)
    bits = vals[:, :N_BITS] < vals[:, N_BITS:]
    packed = pack_bits(bits)
    return torch.where(valid[:, None], packed, torch.zeros_like(packed))
