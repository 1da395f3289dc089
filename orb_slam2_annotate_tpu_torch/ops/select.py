"""Spatially uniform keypoint selection (port of ops/select.py): per-cell
argmax (first index), then a stable top-k over the cell winners.

This is the plain half of kernel 2's twin (``kernels/orb_describe.py``); on
the card the kernel's first stage selects, and nothing here runs."""

from __future__ import annotations

import torch

from .sorting import stable_topk

_HI_BONUS = 1e6


def _pick_cell_size(h: int, w: int, budget: int) -> int:
    """Largest cell size whose grid has >= 2*budget cells (min 8 px)."""
    cs = 64
    while cs > 8 and (h // cs) * (w // cs) < 2 * budget:
        cs //= 2
    return max(cs, 8)


def select_keypoints(score: torch.Tensor, is_hi: torch.Tensor, budget: int,
                     cell_size: int | None = None):
    """score [H,W] f32 (NMS'd), is_hi [H,W] bool -> (xy [budget,2] f32,
    resp [budget] f32, valid [budget] bool)."""
    h, w = score.shape
    dev = score.device
    cs = cell_size or _pick_cell_size(h, w, budget)
    gh, gw = h // cs, w // cs
    s = score[: gh * cs, : gw * cs].reshape(gh, cs, gw, cs).permute(0, 2, 1, 3)
    s = s.reshape(gh * gw, cs * cs)
    hi = is_hi[: gh * cs, : gw * cs].reshape(gh, cs, gw, cs).permute(0, 2, 1, 3)
    hi = hi.reshape(gh * gw, cs * cs)

    prio = s + torch.where(hi, _HI_BONUS, 0.0)
    prio = torch.where(s > 0, prio, torch.full_like(prio, -1.0))
    best = torch.argmax(prio, dim=1)                      # first maximal index
    cell_prio = torch.gather(prio, 1, best[:, None])[:, 0]
    cell_score = torch.gather(s, 1, best[:, None])[:, 0]

    k = min(budget, gh * gw)
    vals, cells = stable_topk(cell_prio, k)
    sel_best = best[cells]
    cy = torch.div(cells, gw, rounding_mode="floor")
    cx = cells % gw
    py = torch.div(sel_best, cs, rounding_mode="floor")
    px = sel_best % cs
    xy = torch.stack([(cx * cs + px).float(), (cy * cs + py).float()], dim=1)
    resp = cell_score[cells]
    valid = vals > 0
    if k < budget:
        pad = budget - k
        xy = torch.cat([xy, torch.zeros(pad, 2, device=dev)])
        resp = torch.cat([resp, torch.zeros(pad, device=dev)])
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dev)])
    return xy, resp, valid


def select_level(score: torch.Tensor, is_hi: torch.Tensor, budget: int, level: int):
    """Corners of one level from its [h,w] score / is_hi: (xy [budget,2]
    level coords, resp, octave, valid)."""
    xy, resp, valid = select_keypoints(score, is_hi, budget)
    octave = torch.full((budget,), level, dtype=torch.int32, device=score.device)
    return xy, resp, octave, valid
