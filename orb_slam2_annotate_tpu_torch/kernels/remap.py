"""Kernel 10: both images of a stereo pair rectified in one launch.

``remap_pair`` launches ``csrc/remap.cu`` for CUDA tensors and runs the
plain twin ``remap_pair_plain`` for CPU tensors; ``remap_pair.launches``
counts kernel launches.  Each image [H, W] f32 is sampled bilinearly at its
map [Ho, Wo, 2] (source x, y), 0 outside the image, as the reference's
``remap_bilinear``; an integer source coordinate returns its pixel bit for
bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


def remap_bilinear_plain(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """img [H, W] sampled at map_xy [Ho, Wo, 2] (x, y); 0 outside."""
    H, W = img.shape
    x, y = map_xy[..., 0], map_xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    flat = img.reshape(-1)

    def at(yy, xx):
        inb = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        v = flat[yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)]
        return torch.where(inb, v, torch.zeros_like(v))

    top = at(y0i, x0i) * (1 - fx) + at(y0i, x0i + 1) * fx
    bot = at(y0i + 1, x0i) * (1 - fx) + at(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def remap_pair_plain(img_l, img_r, map_l, map_r):
    return remap_bilinear_plain(img_l, map_l), remap_bilinear_plain(img_r, map_r)


@functools.cache
def _lib():
    fn = _build.load("remap").remap_pair_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def remap_pair(img_l: torch.Tensor, img_r: torch.Tensor, map_l: torch.Tensor,
               map_r: torch.Tensor):
    """Kernel 10: (img_l at map_l, img_r at map_r); images [H, W] f32, maps
    [Ho, Wo, 2] f32."""
    if not img_l.is_cuda:
        return remap_pair_plain(img_l, img_r, map_l, map_r)
    dev = img_l.device
    H, W = img_l.shape
    Ho, Wo = map_l.shape[:2]
    f32 = torch.float32
    for t, name, shape in ((img_l, "img_l", (H, W)), (img_r, "img_r", (H, W)),
                           (map_l, "map_l", (Ho, Wo, 2)), (map_r, "map_r", (Ho, Wo, 2))):
        _build.check_tensor(t, name, f32, shape, dev)
    if map_l.data_ptr() % 8 or map_r.data_ptr() % 8:
        raise ValueError("remap_pair reads the maps as 8-byte (x, y) vectors: misaligned map")
    out = torch.empty((2, Ho, Wo), dtype=f32, device=dev)
    p = out.data_ptr()
    err = _lib()(img_l.data_ptr(), img_r.data_ptr(), map_l.data_ptr(), map_r.data_ptr(),
                 p, p + 4 * Ho * Wo, H, W, Ho, Wo, _build.stream_ptr(dev))
    _build.check_launch(err, "remap_pair")
    if Ho * Wo:
        remap_pair.launches += 1
    return out[0], out[1]


remap_pair.launches = 0
