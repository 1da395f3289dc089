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


F32 = torch.float32


def check_maps(map_l: torch.Tensor, map_r: torch.Tensor, device):
    """Kernel 10's checks of the maps: both f32 [Ho, Wo, 2], contiguous, on
    `device` and 8-byte aligned.  Returns (Ho, Wo, map_l's pointer, map_r's)
    for ``launch``: a caller that owns fixed maps checks them once."""
    Ho, Wo = map_l.shape[:2]
    shape = (Ho, Wo, 2)
    _build.check_tensor(map_l, "map_l", F32, shape, device)
    _build.check_tensor(map_r, "map_r", F32, shape, device)
    p_l, p_r = map_l.data_ptr(), map_r.data_ptr()
    if p_l % 8 or p_r % 8:
        raise ValueError("remap_pair reads the maps as 8-byte (x, y) vectors: misaligned map")
    return Ho, Wo, p_l, p_r


def check_images(img_l: torch.Tensor, img_r: torch.Tensor, device):
    """Kernel 10's checks of the images: both f32 [H, W], contiguous, on
    `device`.  Returns (H, W)."""
    H, W = img_l.shape
    _build.check_tensor(img_l, "img_l", F32, (H, W), device)
    _build.check_tensor(img_r, "img_r", F32, (H, W), device)
    return H, W


def launch(img_l: torch.Tensor, img_r: torch.Tensor, H: int, W: int, Ho: int, Wo: int, p_l: int,
           p_r: int):
    """Kernel 10 on inputs already checked: the images by ``check_images``
    (or as a caller that made them f32, contiguous, [H, W] on the maps'
    device), the maps by ``check_maps``."""
    dev = img_l.device
    if Ho == H and Wo == W:                  # the cheapest allocation
        out_l, out_r = torch.empty_like(img_l), torch.empty_like(img_l)
    else:
        out_l = torch.empty((Ho, Wo), dtype=F32, device=dev)
        out_r = torch.empty((Ho, Wo), dtype=F32, device=dev)
    err = _lib()(img_l.data_ptr(), img_r.data_ptr(), p_l, p_r, out_l.data_ptr(), out_r.data_ptr(),
                 H, W, Ho, Wo, _build.stream_ptr(dev))
    _build.check_launch(err, "remap_pair")
    if Ho * Wo:
        remap_pair.launches += 1
    return out_l, out_r


def remap_pair(img_l: torch.Tensor, img_r: torch.Tensor, map_l: torch.Tensor,
               map_r: torch.Tensor):
    """Kernel 10: (img_l at map_l, img_r at map_r); images [H, W] f32, maps
    [Ho, Wo, 2] f32."""
    if not img_l.is_cuda:
        return remap_pair_plain(img_l, img_r, map_l, map_r)
    dev = img_l.device
    Ho, Wo, p_l, p_r = check_maps(map_l, map_r, dev)
    H, W = check_images(img_l, img_r, dev)
    return launch(img_l, img_r, H, W, Ho, Wo, p_l, p_r)


remap_pair.launches = 0
