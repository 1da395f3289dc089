"""FAST-9/16 score map and 3x3 NMS, plain torch (port of ops/fast.py).

These are the plain twins of the ``fast_nms`` CUDA kernel
(kernels/fast_nms.py), which fuses the pyramid, the blur, the score, the
NMS and the margin mask of every level into one launch per frame.
"""

from __future__ import annotations

import torch

# 16-pixel Bresenham circle of radius 3, clockwise from 12 o'clock, (dy, dx).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # FAST-9


def _arc_strength(d: torch.Tensor) -> torch.Tensor:
    """d [16,H,W] signed exceedance -> max over arc starts of the min over
    ARC_LEN contiguous circle pixels."""
    best = None
    for start in range(16):
        run = d[start]
        for i in range(1, ARC_LEN):
            run = torch.minimum(run, d[(start + i) % 16])
        best = run if best is None else torch.maximum(best, run)
    return best


def fast_score_map(img: torch.Tensor, threshold_lo: float, threshold_hi: float):
    """img [H,W] f32 -> (score [H,W] f32, is_hi [H,W] bool), 3-px border zeroed."""
    h, w = img.shape
    ring = torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1)) for dy, dx in CIRCLE])
    diff = ring - img[None]
    score_lo = torch.maximum(_arc_strength(diff), _arc_strength(-diff))
    is_lo = score_lo > threshold_lo
    is_hi = score_lo > threshold_hi
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    score = torch.where(is_lo & interior, score_lo, torch.zeros_like(score_lo))
    return score, is_hi & interior


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: keep score only at local maxima."""
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            m = torch.maximum(m, torch.roll(score, (dy, dx), (0, 1)))
    return torch.where(score >= m, score, torch.zeros_like(score))


def margin_mask(score: torch.Tensor, margin: int) -> torch.Tensor:
    """Zero the EDGE margin so descriptor patches stay inside the level."""
    h, w = score.shape
    yy = torch.arange(h, device=score.device)[:, None]
    xx = torch.arange(w, device=score.device)[None, :]
    ok = (yy >= margin) & (yy < h - margin) & (xx >= margin) & (xx < w - margin)
    return torch.where(ok, score, torch.zeros_like(score))
