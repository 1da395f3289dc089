"""Bit-packed Hamming distance, plain torch (port of ops/hamming.py).

Descriptors are [N, 16] int32 bit patterns (512 bits).  torch has no
popcount, so the plain version unpacks each descriptor to 512 signs (+-1)
and takes one matrix product: distance = (512 - <s_a, s_b>) / 2.  That is
exact in float32, because every partial sum is an integer of magnitude at
most 512, and with TF32 off it is exact on the GPU too.  These are the
plain twins of the ``hamming`` CUDA kernel (kernels/hamming.py), which
counts bits with ``__popc``.
"""

from __future__ import annotations

import torch

from .orb import N_BITS

MAX_DIST = N_BITS  # "unmatched" sentinel (> any real distance after gates)


def unpack_signs(desc: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 words -> [..., 32*W] float32, +1 for a set bit and -1
    otherwise, bit k of word w at 32*w + k.  Bytes are looked up in a
    256 x 8 table (the words are little-endian on both host and GPU)."""
    lut = ((torch.arange(256, device=desc.device)[:, None] >> torch.arange(8, device=desc.device))
           & 1).to(torch.float32) * 2 - 1
    by = desc.contiguous().view(torch.uint8).long()
    return torch.nn.functional.embedding(by, lut).flatten(-2)


def hamming_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs distances: a [..., N, W], b [..., M, W] int32 -> [..., N, M] int32."""
    sa = unpack_signs(a)
    sb = sa if b is a else unpack_signs(b)
    return ((32 * a.shape[-1] - sa @ sb.transpose(-1, -2)) * 0.5).to(torch.int32)


def masked_min2(dist: torch.Tensor, mask: torch.Tensor):
    """(best_val, best_idx (first), second_val) along the last axis; masked-out
    lanes read MAX_DIST and second excludes only the argmin lane."""
    d = torch.where(mask, dist, torch.full_like(dist, MAX_DIST))
    best_idx = torch.argmin(d, dim=-1)
    best_val = torch.gather(d, -1, best_idx[..., None])[..., 0]
    d2 = d.scatter(-1, best_idx[..., None], MAX_DIST)
    second_val = d2.min(dim=-1).values
    return best_val, best_idx, second_val
