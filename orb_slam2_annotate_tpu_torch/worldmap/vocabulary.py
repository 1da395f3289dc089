"""Flat binary vocabulary and keyframe database (port of worldmap/vocabulary.py).

Words are [W, 16] int32 bit patterns (the reference's uint32 words viewed as
int32, like every descriptor of the port).  Word assignment is kernel 5
(``kernels/assign_words``): on the card one launch a call, whose 1-bit
tensor-core pass finds each descriptor's nearest word without a distance
matrix.  BoW vectors, L1 scores and candidate retrieval are plain torch.
``train_vocabulary`` is the offline trainer (batched binary k-means, its
assignment step kernel 5 on the card) and ``save_vocabulary`` writes the
reference's file format.
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
from ..ops.orb import DESC_WORDS, N_BITS
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


def save_vocabulary(path: str, vocab: Vocabulary):
    """The reference's format: an npz of uint32 ``words`` and float32
    ``idf``, so a file of either package loads in the other bit for bit."""
    np.savez(path, words=vocab.words.cpu().numpy().view(np.uint32),
             idf=vocab.idf.cpu().numpy().astype(np.float32))


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[M, 16] int32 words -> [M, 512] int32 bits, bit b of word w at
    32 w + b (numpy's little-endian unpackbits order)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shifts) & 1).reshape(words.shape[0], N_BITS)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[W, 512] 0/1 -> [W, 16] int32 words (the inverse of _unpack_bits)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (bits.reshape(bits.shape[0], DESC_WORDS, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def train_vocabulary(descs, n_words: int = 4096, iters: int = 8, seed: int = 0,
                     doc_ids: np.ndarray | None = None, device="cuda") -> Vocabulary:
    """Batched binary k-means (majority-bit medians) over [M, 16]
    descriptors (uint32 or int32 bit patterns, numpy or a tensor), plus the
    corpus IDF when each descriptor's document (image) id is given: idf =
    log(N / N_i), 0 for a word in no document.  The initial centroids are
    the reference's RandomState draw; the assignment step is kernel 5 on the
    card (its plain twin on the CPU), in the reference's chunks, ties to the
    lowest word; the majority bits are integer counts, so the words equal
    the reference's exactly."""
    if torch.is_tensor(descs):
        d = descs.to(device=device, dtype=torch.int32).contiguous()
    else:
        d = torch.from_numpy(np.ascontiguousarray(descs).view(np.int32)).to(device)
    rng = np.random.RandomState(seed)
    M = d.shape[0]
    pick = rng.choice(M, n_words, replace=M < n_words)
    centroids = d[torch.from_numpy(pick).to(d.device)].contiguous()
    bits = _unpack_bits(d)
    valid = torch.ones(M, dtype=torch.bool, device=d.device)
    # the reference's chunks of the assignment step: at most 2^28 pairs each
    chunk = max(1, min(M, (1 << 28) // max(n_words, 1)))

    def assign_all(cent):
        return torch.cat([_assign_words_kernel(d[s:s + chunk], cent, valid[s:s + chunk])
                          for s in range(0, M, chunk)]).long()

    assign = None
    for _ in range(iters):
        assign = assign_all(centroids)
        ones = torch.zeros((n_words, N_BITS), dtype=torch.int32, device=d.device).index_add_(
            0, assign, bits)
        count = torch.bincount(assign, minlength=n_words)
        # ones > 0.5 max(count, 1), in integers
        maj = 2 * ones > torch.clamp_min(count, 1)[:, None]
        centroids = torch.where((count > 0)[:, None], _pack_bits(maj), centroids).contiguous()
    idf = np.ones((n_words,), np.float32)
    if doc_ids is not None and assign is not None:
        # re-assign against the final centroids, then document frequency
        final = assign_all(centroids).cpu().numpy()
        doc_ids = np.asarray(doc_ids)
        n_docs = int(doc_ids.max()) + 1
        df = np.zeros((n_words,), np.int64)
        pairs = np.unique(np.stack([final, doc_ids], 1), axis=0)
        np.add.at(df, pairs[:, 0], 1)
        idf = np.log(n_docs / np.maximum(df, 1)).astype(np.float32)
        idf = np.where(df == 0, 0.0, idf)
    return Vocabulary(centroids, torch.from_numpy(np.asarray(idf, np.float32)).to(d.device))


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


def bow_rows(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``bow_vector`` of each row: desc [R, N, 16], valid [R, N] -> [R, W],
    all R x N descriptors in one word assignment (one kernel-5 launch on the
    card)."""
    R, N = valid.shape
    v = valid.reshape(-1)
    w = assign_words(vocab, desc.reshape(R * N, -1), v)
    rows = torch.arange(R, device=desc.device).repeat_interleave(N)
    flat = rows * vocab.n_words + torch.clamp_min(w, 0).long()
    counts = torch.zeros(R * vocab.n_words, dtype=torch.float32, device=desc.device).index_add(
        0, flat, v.to(torch.float32)).reshape(R, vocab.n_words) * vocab.idf
    return counts / torch.clamp_min(counts.sum(1, keepdim=True), 1e-9)


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
