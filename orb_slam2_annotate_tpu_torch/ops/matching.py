"""Data association (port of ops/matching.py): candidate masks + the fused
masked matcher (kernel 3) + rotation-histogram consistency."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.hamming import hamming_match
from .hamming import MAX_DIST

TH_LOW = 134
TH_HIGH = 184
HISTO_LENGTH = 30


def rotation_consistency(angle1: torch.Tensor, angle2: torch.Tensor,
                         matched: torch.Tensor) -> torch.Tensor:
    """Keep matches whose rotation offset lies in the 3 dominant histogram
    bins (bins 2 and 3 only above 10% of bin 1)."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle1 - angle2, two_pi)
    bins = torch.clamp(torch.round(rot * (HISTO_LENGTH / two_pi)).long(), 0, HISTO_LENGTH) \
        % HISTO_LENGTH
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=angle1.device)
    hist = hist.index_add(0, bins, matched.to(torch.int32))
    order = torch.argsort(-hist, stable=True)
    top = hist[order[:3]].float()
    keep_bin = torch.stack([torch.ones((), dtype=torch.bool, device=hist.device),
                            top[1] > 0.1 * top[0], top[2] > 0.1 * top[0]])
    in_top = torch.zeros(HISTO_LENGTH, dtype=torch.bool, device=hist.device)
    in_top = in_top.index_put((order[:3],), keep_bin)
    return matched & in_top[bins]


@dataclasses.dataclass
class MatchResult:
    idx: torch.Tensor   # [N1] int32 index into set 2, -1 if unmatched
    dist: torch.Tensor  # [N1] int32 distance (MAX_DIST if unmatched)

    @property
    def matched(self):
        return self.idx >= 0

    @property
    def count(self):
        return torch.sum(self.idx >= 0)


def match_masked(desc1, desc2, cand_mask, max_dist=TH_LOW, ratio=1.0,
                 mutual=False) -> MatchResult:
    """Masked matcher: best under the mask, ratio test, then column dedup or
    the mutual check; desc [N,16] int32, cand_mask [N1,N2] bool."""
    idx, dist = hamming_match(desc1, desc2, cand_mask.contiguous(), max_dist, ratio, mutual)
    return MatchResult(idx, dist)


def window_mask(xy1_proj: torch.Tensor, xy2: torch.Tensor, radius) -> torch.Tensor:
    """Circular-window candidate mask [N1, N2]; radius scalar or [N1]."""
    dx = xy1_proj[:, None, 0] - xy2[None, :, 0]
    dy = xy1_proj[:, None, 1] - xy2[None, :, 1]
    d2 = dx * dx + dy * dy
    r = torch.as_tensor(radius, dtype=torch.float32, device=xy1_proj.device)
    r = torch.broadcast_to(r, (xy1_proj.shape[0],))
    return d2 <= (r[:, None] ** 2)


def octave_mask(pred_octave: torch.Tensor, octave2: torch.Tensor, lo_off: int = -1,
                hi_off: int = 1) -> torch.Tensor:
    o = pred_octave[:, None]
    return (octave2[None, :] >= o + lo_off) & (octave2[None, :] <= o + hi_off)


def _with_rotation_check(res: MatchResult, angle1, angle2_all) -> MatchResult:
    ang2 = angle2_all[torch.clamp_min(res.idx, 0).long()]
    keep = rotation_consistency(angle1, ang2, res.matched)
    return MatchResult(torch.where(keep, res.idx, -1).to(torch.int32),
                       torch.where(keep, res.dist, MAX_DIST).to(torch.int32))


def search_for_initialization(f1, f2, window: float = 100.0, ratio: float = 0.9) -> MatchResult:
    """Level-0 windowed matching for monocular initialization."""
    cand = window_mask(f1.xy, f2.xy, window)
    cand &= (f1.octave[:, None] == 0) & (f2.octave[None, :] == 0)
    cand &= f1.valid[:, None] & f2.valid[None, :]
    res = match_masked(f1.desc, f2.desc, cand, TH_LOW, ratio, mutual=False)
    return _with_rotation_check(res, f1.angle, f2.angle)


def search_frame_to_frame(f_cur, f_last, proj_xy, proj_valid, pred_octave, radius_px,
                          ratio: float = 0.9, max_dist: int = TH_HIGH) -> MatchResult:
    """Motion-model match: last frame's projected points vs current keypoints."""
    cand = window_mask(proj_xy, f_cur.xy, radius_px)
    cand &= octave_mask(pred_octave, f_cur.octave, -1, 1)
    cand &= proj_valid[:, None] & f_cur.valid[None, :]
    res = match_masked(f_last.desc, f_cur.desc, cand, max_dist, ratio)
    return _with_rotation_check(res, f_last.angle, f_cur.angle)


def search_map_points(point_desc, point_valid, proj_xy, pred_octave, radius_px, f_cur,
                      ratio: float = 0.8, max_dist: int = TH_HIGH) -> MatchResult:
    """Track-local-map match: candidate map points vs current keypoints."""
    cand = window_mask(proj_xy, f_cur.xy, radius_px)
    cand &= octave_mask(pred_octave, f_cur.octave, -1, 1)
    cand &= point_valid[:, None] & f_cur.valid[None, :]
    return match_masked(point_desc, f_cur.desc, cand, max_dist, ratio)


def search_for_triangulation(f1, f2, F12, inv_sigma2_1, inv_sigma2_2,
                             exclude1=None, exclude2=None) -> MatchResult:
    """Epipolar-gated matching for new map-point triangulation."""
    x1h = torch.cat([f1.xy, torch.ones_like(f1.xy[:, :1])], dim=1)
    lines = x1h @ F12
    x2h = torch.cat([f2.xy, torch.ones_like(f2.xy[:, :1])], dim=1)
    num = (lines @ x2h.T) ** 2
    den = torch.clamp_min(lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2, 1e-12)
    dsq = num / den
    sigma2_2 = 1.0 / inv_sigma2_2[f2.octave.long()]
    epi_ok = dsq < 3.84 * sigma2_2[None, :]
    cand = epi_ok & f1.valid[:, None] & f2.valid[None, :]
    if exclude1 is not None:
        cand &= ~exclude1[:, None]
    if exclude2 is not None:
        cand &= ~exclude2[None, :]
    res = match_masked(f1.desc, f2.desc, cand, TH_LOW, ratio=1.0, mutual=False)
    return _with_rotation_check(res, f1.angle, f2.angle)
