"""Flat binary vocabulary and keyframe database (port of worldmap/vocabulary.py).

Words are [W, 16] int32 bit patterns (the reference's uint32 words viewed as
int32, like every descriptor of the port).  Word assignment is kernel 5
(``kernels/assign_words``): on the card one launch a call, whose 1-bit
tensor-core pass finds each descriptor's nearest word without a distance
matrix.  BoW vectors, L1 scores and candidate retrieval are plain torch.
Scoring is DBoW2's L1 score on L1-normalised TF-IDF vectors:
s(v, w) = 1 - 0.5 * |v - w|_1.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..kernels.assign_words import assign_words as _assign_words_kernel
from ..ops.hamming import unpack_signs
from ..ops.orb import DESC_WORDS
from ..ops.sorting import stable_topk


@dataclasses.dataclass(eq=False)
class Vocabulary:
    """words [W, 16] int32 centroids; idf [W] float32 word weights."""

    words: torch.Tensor
    idf: torch.Tensor

    @property
    def n_words(self) -> int:
        return self.words.shape[0]

    @functools.cached_property
    def signs(self) -> torch.Tensor:
        """[W, 512] float32 +-1 form of the words, for the plain assignment;
        unpacked once per vocabulary."""
        return unpack_signs(self.words)


def make_vocabulary(n_words: int = 4096, seed: int = 42, device=None) -> Vocabulary:
    """Random binary vocabulary (uniform IDF), the reference's draws."""
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 2**32, size=(n_words, DESC_WORDS), dtype=np.uint64).astype(np.uint32)
    return Vocabulary(torch.from_numpy(words.view(np.int32)).to(device),
                      torch.ones(n_words, dtype=torch.float32, device=device))


def load_vocabulary(path: str, device=None) -> Vocabulary:
    """A vocabulary saved by the reference's ``save_vocabulary`` (npz of
    uint32 ``words`` and float32 ``idf``), read with numpy."""
    z = np.load(path)
    words = np.ascontiguousarray(z["words"], dtype=np.uint32).view(np.int32)
    return Vocabulary(torch.from_numpy(words).to(device),
                      torch.from_numpy(np.asarray(z["idf"], np.float32)).to(device))


def assign_words(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Nearest word per descriptor, lowest index among ties: [N] int32, -1
    where not valid."""
    signs = None if vocab.words.is_cuda else vocab.signs
    return _assign_words_kernel(desc.contiguous(), vocab.words, valid.contiguous(), signs)


def bow_vector(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """L1-normalised TF-IDF BoW vector [W] float32."""
    w = assign_words(vocab, desc, valid)
    counts = torch.zeros(vocab.n_words, dtype=torch.float32, device=desc.device).index_add(
        0, torch.clamp_min(w, 0).long(), valid.to(torch.float32))
    counts = counts * vocab.idf
    return counts / torch.clamp_min(counts.sum(), 1e-9)


def l1_scores(bows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity of q [W] against each row of bows [K, W]."""
    return 1.0 - 0.5 * torch.abs(bows - q[None, :]).sum(1)


@dataclasses.dataclass
class KeyFrameDatabase:
    """Dense BoW table over keyframe slots, bows [K, W] float32.  Rows of
    culled keyframes stay: queries mask by ``kf_valid``, as the reference does."""

    bows: torch.Tensor

    @staticmethod
    def create(max_kf: int, n_words: int, device=None) -> "KeyFrameDatabase":
        return KeyFrameDatabase(torch.zeros((max_kf, n_words), dtype=torch.float32, device=device))

    def add(self, slot: int, bow: torch.Tensor) -> "KeyFrameDatabase":
        bows = self.bows.clone()
        bows[slot] = bow
        return KeyFrameDatabase(bows)

    def erase(self, slot: int) -> "KeyFrameDatabase":
        return self.add(slot, torch.zeros_like(self.bows[slot]))


def detect_relocalization_candidates(db: KeyFrameDatabase, q: torch.Tensor,
                                     kf_valid: torch.Tensor, covis: torch.Tensor | None = None,
                                     max_candidates: int = 8):
    """Score every valid keyframe, accumulate over its covisible group (when
    ``covis`` [K, K] is given), keep >= 0.75 x the best accumulated score.
    Returns (slots [max_candidates] int64, ok [max_candidates] bool)."""
    s = torch.where(kf_valid, l1_scores(db.bows, q), -1.0)
    if covis is not None:
        acc = s + torch.where(covis > 0, s[None, :], 0.0).sum(1)
    else:
        acc = s
    ok_mask = kf_valid & (acc >= 0.75 * acc.max()) & (s > 0)
    top, slots = stable_topk(torch.where(ok_mask, acc, -1.0), max_candidates)
    return slots, top > 0


def detect_loop_candidates(db: KeyFrameDatabase, q: torch.Tensor, kf_valid: torch.Tensor,
                           exclude: torch.Tensor, min_score: torch.Tensor,
                           max_candidates: int = 8):
    """Like relocalization, without the ``exclude`` [K] slots and
    thresholded at ``min_score``.  Returns (slots int64, ok bool)."""
    s = torch.where(kf_valid & ~exclude, l1_scores(db.bows, q), -1.0)
    ok = s >= torch.clamp_min(min_score, 0.0)
    top, slots = stable_topk(torch.where(ok, s, -1.0), max_candidates)
    return slots, top > 0
