"""Image pyramid + separable Gaussian blur (port of ops/pyramid.py).

The reference builds level l with ``jax.image.resize(linear,
antialias=True)``: one contraction with a [H, h] and a [W, w] weight matrix
from ``compute_weight_mat`` (jax/_src/image/scale.py).  The weights are
recomputed here in float32 numpy with the same arithmetic;
``F.interpolate(antialias=True)`` gives other weights, and pixel drift flips
FAST corners and BRIEF bits.  Both the resize and the blur stay plain torch.
"""

from __future__ import annotations

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


def build_pyramid(image: torch.Tensor, n_levels: int = 8, scale: float = 1.2):
    """Grayscale f32 [H,W] image -> list of n_levels tensors (level 0 first)."""
    h, w = image.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [image]
    for l in range(1, n_levels):
        wh = torch.from_numpy(resize_weights(h, shapes[l][0])).to(image.device)
        ww = torch.from_numpy(resize_weights(w, shapes[l][1])).to(image.device)
        levels.append(wh.T @ image @ ww)
    return levels


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
