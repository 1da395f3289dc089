"""Kernel 3: fused masked Hamming match and batched all-pairs Hamming.

``hamming_match`` and ``hamming_pairwise_batched`` launch
``csrc/hamming.cu`` for CUDA tensors and run their plain twins
(``hamming_match_plain``, ``hamming_pairwise_batched_plain``) for CPU
tensors.  Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.hamming import MAX_DIST, hamming_pairwise, masked_min2
from ..ops.orb import DESC_WORDS
from . import _build


def hamming_match_plain(desc1, desc2, cand_mask, max_dist: int, ratio: float, mutual: bool):
    """desc1 [N1,16], desc2 [N2,16] int32, cand_mask [N1,N2] bool ->
    (idx [N1] int32, -1 if unmatched; dist [N1] int32, MAX_DIST if unmatched)."""
    d = hamming_pairwise(desc1, desc2)
    best, bidx, second = masked_min2(d, cand_mask)
    ok = (best <= max_dist) & (best.float() < ratio * second.float())
    dm = torch.where(cand_mask, d, torch.full_like(d, MAX_DIST))
    if mutual:
        rbest_idx = torch.argmin(dm, dim=0)
        ok = ok & (rbest_idx[bidx] == torch.arange(desc1.shape[0], device=desc1.device))
    else:
        col_best = dm.min(dim=0).values
        ok = ok & (best <= col_best[bidx])
    idx = torch.where(ok, bidx, -1).to(torch.int32)
    dist = torch.where(ok, best, MAX_DIST).to(torch.int32)
    return idx, dist


def hamming_pairwise_batched_plain(a, b):
    """a, b [Q,M,16] int32 -> [Q,M,M] int32."""
    return hamming_pairwise(a, b).to(torch.int32)


@functools.cache
def _fns():
    lib = _build.load("hamming")
    match = lib.hamming_match_launch
    match.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int] \
        + [ctypes.c_void_p] * 7
    match.restype = ctypes.c_int
    pair = lib.hamming_pairwise_batched_launch
    pair.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    pair.restype = ctypes.c_int
    return match, pair


def hamming_match(desc1, desc2, cand_mask, max_dist: int, ratio: float, mutual: bool = False):
    if not desc1.is_cuda:
        return hamming_match_plain(desc1, desc2, cand_mask, max_dist, ratio, mutual)
    dev = desc1.device
    N1, N2 = desc1.shape[0], desc2.shape[0]
    _build.check_tensor(desc1, "desc1", torch.int32, (N1, DESC_WORDS), dev)
    _build.check_tensor(desc2, "desc2", torch.int32, (N2, DESC_WORDS), dev)
    _build.check_tensor(cand_mask, "cand_mask", torch.bool, (N1, N2), dev)
    colkey = torch.empty((N2,), dtype=torch.int64, device=dev)
    scratch = torch.empty((3, N1), dtype=torch.int32, device=dev)
    idx = torch.empty((N1,), dtype=torch.int32, device=dev)
    dist = torch.empty((N1,), dtype=torch.int32, device=dev)
    match, _ = _fns()
    err = match(desc1.data_ptr(), desc2.data_ptr(), cand_mask.data_ptr(), N1, N2,
                int(max_dist), float(ratio), int(bool(mutual)), colkey.data_ptr(),
                scratch[0].data_ptr(), scratch[1].data_ptr(), scratch[2].data_ptr(),
                idx.data_ptr(), dist.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "hamming_match")
    hamming_match.launches += 1
    return idx, dist


def hamming_pairwise_batched(a, b):
    if not a.is_cuda:
        return hamming_pairwise_batched_plain(a, b)
    dev = a.device
    Q, M = a.shape[0], a.shape[1]
    _build.check_tensor(a, "a", torch.int32, (Q, M, DESC_WORDS), dev)
    _build.check_tensor(b, "b", torch.int32, (Q, M, DESC_WORDS), dev)
    out = torch.empty((Q, M, M), dtype=torch.int32, device=dev)
    _, pair = _fns()
    err = pair(a.data_ptr(), b.data_ptr(), Q, M, out.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "hamming_pairwise_batched")
    hamming_pairwise_batched.launches += 1
    return out


hamming_match.launches = 0
hamming_pairwise_batched.launches = 0
