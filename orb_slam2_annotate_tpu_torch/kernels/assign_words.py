"""Kernel 5: nearest vocabulary word per descriptor (Hamming argmin).

``assign_words`` launches ``csrc/assign_words.cu`` for CUDA tensors, one
launch a call (the distances on the 1-bit tensor cores, the row minima
combined across CTAs in a per-device workspace that the kernel's last CTAs
reset), and runs its plain twin ``assign_words_plain`` for CPU tensors;
``launches`` counts kernel launches.  Both return the lowest word index
among equal distances (``jnp.argmin`` order).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.hamming import unpack_signs
from ..ops.orb import DESC_WORDS, N_BITS
from . import _build

MAX_WORDS = 1 << 20   # the kernel packs (distance << 20 | word) into 32 bits


def assign_words_plain(desc, words, valid, word_signs=None):
    """desc [N,16], words [W,16] int32, valid [N] bool -> [N] int32 word
    index (-1 where not valid).  ``word_signs`` is the words' +-1 form
    (``ops.hamming.unpack_signs``), unpacked here when not given."""
    signs = unpack_signs(words) if word_signs is None else word_signs
    dist = (N_BITS - unpack_signs(desc) @ signs.T) * 0.5       # exact integers in f32
    w = torch.argmin(dist, dim=1)                              # first minimum
    return torch.where(valid, w, -1).to(torch.int32)


@functools.cache
def _fn():
    fn = _build.load("assign_words").assign_words_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


CTA_ROWS = 256          # descriptor rows a CTA takes (csrc/assign_words.cu)
_INT_MAX = 2**31 - 1
_WORKSPACE: dict = {}   # device -> (key [>= N] i32, ticket [>= row blocks] i32)


def _workspace(dev, N: int):
    """The device's workspace, grown to fit.  Between calls the keys hold
    INT_MAX and the tickets 0: the kernel's finishing CTAs restore both, and
    calls on one stream run in order."""
    ws = _WORKSPACE.get(dev)
    if ws is None or ws[0].numel() < N:
        ws = (torch.full((N,), _INT_MAX, dtype=torch.int32, device=dev),
              torch.zeros((-(-N // CTA_ROWS),), dtype=torch.int32, device=dev))
        _WORKSPACE[dev] = ws
    return ws


def assign_words(desc, words, valid, word_signs=None):
    if not desc.is_cuda:
        return assign_words_plain(desc, words, valid, word_signs)
    dev = desc.device
    N, W = desc.shape[0], words.shape[0]
    if not 0 < W < MAX_WORDS:
        raise ValueError(f"assign_words: {W} words, the kernel takes 1 to {MAX_WORDS - 1}")
    _build.check_tensor(desc, "desc", torch.int32, (N, DESC_WORDS), dev)
    _build.check_tensor(words, "words", torch.int32, (W, DESC_WORDS), dev)
    _build.check_tensor(valid, "valid", torch.bool, (N,), dev)
    if words.data_ptr() % 16:
        raise ValueError("assign_words: words must be 16-byte aligned (read with 16-byte copies)")
    key, ticket = _workspace(dev, N)
    out = torch.empty((N,), dtype=torch.int32, device=dev)
    err = _fn()(desc.data_ptr(), words.data_ptr(), valid.data_ptr(), N, W, key.data_ptr(),
                ticket.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
    _build.check_launch(err, "assign_words")
    assign_words.launches += 1
    return out


assign_words.launches = 0
