"""Image pyramid + separable Gaussian blur (port of ops/pyramid.py).

The reference builds level l with ``jax.image.resize(linear,
antialias=True)``: one contraction with a [H, h] and a [W, w] weight matrix
from ``compute_weight_mat`` (jax/_src/image/scale.py).  The weights are
recomputed here in float32 numpy with the same arithmetic;
``F.interpolate(antialias=True)`` gives other weights, and pixel drift flips
FAST corners and BRIEF bits.  Each weight matrix is a band (triangle taps),
so the resize is kept as per-output tap offsets and weights
(``level_tables``, made once per shape and device) and summed tap by tap
(``resize_stack``): rows first, then columns, in the order kernel 1
(kernels/fast_nms.py) sums them, so the two agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static per-level (h, w) sizes, matching cvRound semantics."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / (scale**l)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 triangle-kernel antialiased resize
    weights, as jax.image's compute_weight_mat computes them."""
    f32 = np.float32
    scale = f32(out_size / in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.0) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    ok = np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps))
    w = np.where(ok, w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _band(in_size: int, out_size: int, level0: bool):
    """(first tap [in_size] int32, taps [in_size, T] f32, T) of one axis:
    output o reads inputs first[o] .. first[o] + T - 1 (the band of
    ``resize_weights``' column o, zero-padded); entries beyond out_size are 0."""
    if level0:
        first, taps = np.arange(in_size, dtype=np.int32), np.ones((in_size, 1), np.float32)
    else:
        w = resize_weights(in_size, out_size)
        nz = w != 0
        any_nz = nz.any(axis=0)
        first = np.where(any_nz, nz.argmax(axis=0), 0).astype(np.int32)
        last = np.where(any_nz, in_size - 1 - nz[::-1].argmax(axis=0), 0)
        n = int((last - first).max()) + 1
        idx = np.minimum(first[:, None] + np.arange(n), in_size - 1)
        taps = np.take_along_axis(w.T, idx, axis=1)
        taps[first[:, None] + np.arange(n) > in_size - 1] = 0.0
        if not np.array_equal((taps != 0).sum(1), nz.sum(0)):
            raise AssertionError("resize weights are not one band per output")
    f = np.zeros(in_size, np.int32)
    t = np.zeros((in_size, taps.shape[1]), np.float32)
    f[:out_size], t[:out_size] = first, taps
    return f, t, taps.shape[1]


@dataclasses.dataclass(frozen=True)
class LevelTables:
    """The constants of a frame's pyramid, made once per (H, W, levels,
    scale, device): level l resizes the level-0 image with row taps
    row_first[l, y] + k, weights row_w[l, y, k] for k < taps[l][0], and the
    same for columns; level 0 is the identity (one tap of 1.0)."""

    shapes: tuple            # ((h, w), ...) per level
    taps: tuple              # ((row taps, column taps), ...) per level
    level_hw: torch.Tensor   # [L,2] int32
    n_taps: torch.Tensor     # [L,2] int32, `taps` on the device
    row_first: torch.Tensor  # [L,H0] int32
    row_w: torch.Tensor      # [L,H0,T] f32
    col_first: torch.Tensor  # [L,W0] int32
    col_w: torch.Tensor      # [L,W0,T] f32
    scales: torch.Tensor     # [L] f32, scale**l


@functools.lru_cache(maxsize=16)
def _level_tables(height: int, width: int, n_levels: int, scale: float, device: str):
    shapes = pyramid_shapes(height, width, n_levels, scale)
    rows = [_band(height, h, l == 0) for l, (h, _) in enumerate(shapes)]
    cols = [_band(width, w, l == 0) for l, (_, w) in enumerate(shapes)]
    T = max(max(r[2] for r in rows), max(c[2] for c in cols))

    def stack(parts, n):
        first = np.stack([p[0] for p in parts])
        w = np.zeros((n_levels, n, T), np.float32)
        for l, p in enumerate(parts):
            w[l, :, :p[2]] = p[1]
        return torch.from_numpy(first).to(device), torch.from_numpy(w).to(device)

    row_first, row_w = stack(rows, height)
    col_first, col_w = stack(cols, width)
    taps = tuple((r[2], c[2]) for r, c in zip(rows, cols))
    i32 = torch.int32
    return LevelTables(tuple(shapes), taps, torch.tensor(shapes, dtype=i32, device=device),
                       torch.tensor(taps, dtype=i32, device=device), row_first, row_w, col_first,
                       col_w, level_scales(n_levels, scale, device=device))


def level_tables(height: int, width: int, n_levels: int, scale: float, device) -> LevelTables:
    return _level_tables(height, width, n_levels, float(scale), str(torch.device(device)))


def resize_stack(image: torch.Tensor, lt: LevelTables) -> torch.Tensor:
    """[H0,W0] f32 -> [L,H0,W0] zero-padded levels, summed tap by tap in
    kernel 1's order (rows, then columns; taps of weight 0 add +0)."""
    H0, W0 = image.shape
    out = image.new_zeros((len(lt.shapes), H0, W0))
    for l, ((h, w), (ty, tx)) in enumerate(zip(lt.shapes, lt.taps)):
        first = lt.row_first[l, :h].long()
        tmp = torch.zeros((h, W0), dtype=image.dtype, device=image.device)
        for k in range(ty):
            tmp = tmp + lt.row_w[l, :h, k, None] * image[torch.clamp(first + k, max=H0 - 1)]
        first = lt.col_first[l, :w].long()
        acc = torch.zeros((h, w), dtype=image.dtype, device=image.device)
        for k in range(tx):
            acc = acc + lt.col_w[l, None, :w, k] * tmp[:, torch.clamp(first + k, max=W0 - 1)]
        out[l, :h, :w] = acc
    return out


def build_pyramid(image: torch.Tensor, n_levels: int = 8, scale: float = 1.2):
    """Grayscale f32 [H,W] image -> list of n_levels tensors (level 0 first)."""
    h, w = image.shape
    lt = level_tables(h, w, n_levels, scale, image.device)
    pyr3 = resize_stack(image, lt)
    return [image] + [pyr3[l, :lh, :lw] for l, (lh, lw) in enumerate(lt.shapes) if l > 0]


@functools.lru_cache(maxsize=8)
def _gaussian_kernel_1d(ksize: int, sigma: float):
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float32)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / np.sum(k)


def gaussian_blur(image: torch.Tensor, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with BORDER_REFLECT_101 borders, summed in
    the reference's order."""
    k = _gaussian_kernel_1d(ksize, sigma)
    half = ksize // 2
    h, w = image.shape
    x = torch.nn.functional.pad(image[None, None], (half, half, half, half),
                                mode="reflect")[0, 0]
    acc = float(k[0]) * x[0:h, :]
    for i in range(1, ksize):
        acc = acc + float(k[i]) * x[i:i + h, :]
    out = float(k[0]) * acc[:, 0:w]
    for j in range(1, ksize):
        out = out + float(k[j]) * acc[:, j:j + w]
    return out


def level_scales(n_levels: int = 8, scale: float = 1.2, device=None):
    return torch.tensor([scale**l for l in range(n_levels)], dtype=torch.float32,
                        device=device)


def features_per_level(n_features: int, n_levels: int = 8, scale: float = 1.2):
    """Geometric-series feature budget per level (ORBextractor.cc:448-458)."""
    factor = 1.0 / scale
    n_first = n_features * (1.0 - factor) / (1.0 - factor**n_levels)
    counts = []
    total = 0
    for l in range(n_levels - 1):
        c = int(round(n_first * (factor**l)))
        counts.append(c)
        total += c
    counts.append(max(n_features - total, 0))
    return counts
