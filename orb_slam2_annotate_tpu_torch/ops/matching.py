"""Data association (port of ops/matching.py): the gated matcher (kernel 3)
+ rotation-histogram consistency.

Every search passes its candidate gate (validity, window + octave band,
epipolar distance) to the kernel, which evaluates it per pair: no [N1,N2]
mask is built.  The searches batch: a frame's arrays may carry a leading
batch dimension (one problem each), and the result then has one too."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.hamming import EpipolarGate, MaskGate, WindowGate, hamming_match
from .hamming import MAX_DIST

TH_LOW = 134
TH_HIGH = 184
HISTO_LENGTH = 30


def rotation_consistency(angle1: torch.Tensor, angle2: torch.Tensor,
                         matched: torch.Tensor) -> torch.Tensor:
    """Keep matches whose rotation offset lies in the 3 dominant histogram
    bins (bins 2 and 3 only above 10% of bin 1).  Inputs [..., N]: one
    histogram per row of the leading dimensions."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle1 - angle2, two_pi)
    bins = torch.clamp(torch.round(rot * (HISTO_LENGTH / two_pi)).long(), 0, HISTO_LENGTH) \
        % HISTO_LENGTH
    bins, matched = torch.broadcast_tensors(bins, matched)
    n = bins.shape[-1]
    b2, m2 = bins.reshape(-1, n), matched.reshape(-1, n)
    rows = b2.shape[0]
    hist = torch.zeros((rows, HISTO_LENGTH), dtype=torch.int32, device=bins.device)
    hist = hist.scatter_add(1, b2, m2.to(torch.int32))
    order = torch.argsort(-hist, dim=1, stable=True)[:, :3]
    top = torch.gather(hist, 1, order).float()
    keep_bin = torch.stack([torch.ones(rows, dtype=torch.bool, device=bins.device),
                            top[:, 1] > 0.1 * top[:, 0], top[:, 2] > 0.1 * top[:, 0]], dim=1)
    in_top = torch.zeros((rows, HISTO_LENGTH), dtype=torch.bool, device=bins.device)
    in_top = in_top.scatter(1, order, keep_bin)
    return (m2 & torch.gather(in_top, 1, b2)).reshape(matched.shape)


@dataclasses.dataclass
class MatchResult:
    idx: torch.Tensor   # [B?,N1] int32 index into set 2, -1 if unmatched
    dist: torch.Tensor  # [B?,N1] int32 distance (MAX_DIST if unmatched)

    @property
    def matched(self):
        return self.idx >= 0

    @property
    def count(self):
        return torch.sum(self.idx >= 0)


def match_gated(desc1, desc2, row_valid, col_valid, max_dist=TH_LOW, ratio=1.0, mutual=False,
                gate=None) -> MatchResult:
    """Best gated candidate, ratio test, then column dedup or the mutual
    check, in one kernel launch for all problems of the call."""
    return MatchResult(*hamming_match(desc1, desc2, row_valid, col_valid, max_dist, ratio,
                                      mutual, gate))


def match_masked(desc1, desc2, cand_mask, max_dist=TH_LOW, ratio=1.0,
                 mutual=False) -> MatchResult:
    """The reference's masked matcher: desc [N,16] int32, cand_mask [N1,N2] bool."""
    return match_gated(desc1, desc2, None, None, max_dist, ratio, mutual,
                       MaskGate(cand_mask.contiguous()))


def _with_rotation_check(res: MatchResult, angle1, angle2_all) -> MatchResult:
    idc = torch.clamp_min(res.idx, 0).long()
    ang2 = angle2_all[idc] if angle2_all.dim() == 1 else torch.gather(angle2_all, -1, idc)
    keep = rotation_consistency(angle1, ang2, res.matched)
    return MatchResult(torch.where(keep, res.idx, -1).to(torch.int32),
                       torch.where(keep, res.dist, MAX_DIST).to(torch.int32))


def search_for_initialization(f1, f2, window: float = 100.0, ratio: float = 0.9) -> MatchResult:
    """Level-0 windowed matching for monocular initialization."""
    res = match_gated(f1.desc, f2.desc, f1.valid & (f1.octave == 0), f2.valid & (f2.octave == 0),
                      TH_LOW, ratio, gate=WindowGate(f1.xy, float(window), f2.xy))
    return _with_rotation_check(res, f1.angle, f2.angle)


def search_frame_to_frame(f_cur, f_last, proj_xy, proj_valid, pred_octave, radius_px,
                          ratio: float = 0.9, max_dist: int = TH_HIGH) -> MatchResult:
    """Motion-model match: last frame's projected points vs current keypoints."""
    gate = WindowGate(proj_xy, radius_px, f_cur.xy, pred_octave, f_cur.octave, -1, 1)
    res = match_gated(f_last.desc, f_cur.desc, proj_valid, f_cur.valid, max_dist, ratio, gate=gate)
    return _with_rotation_check(res, f_last.angle, f_cur.angle)


def search_map_points(point_desc, point_valid, proj_xy, pred_octave, radius_px, f_cur,
                      ratio: float = 0.8, max_dist: int = TH_HIGH) -> MatchResult:
    """Track-local-map match: candidate map points vs current keypoints."""
    gate = WindowGate(proj_xy, radius_px, f_cur.xy, pred_octave, f_cur.octave, -1, 1)
    return match_gated(point_desc, f_cur.desc, point_valid, f_cur.valid, max_dist, ratio,
                       gate=gate)


def search_for_triangulation(f1, f2, F12, inv_sigma2_1, inv_sigma2_2,
                             exclude1=None, exclude2=None) -> MatchResult:
    """Epipolar-gated matching for new map-point triangulation.  f2's arrays,
    F12 and exclude2 may carry a batch dimension (one neighbour each)."""
    rv = f1.valid if exclude1 is None else f1.valid & ~exclude1
    cv = f2.valid if exclude2 is None else f2.valid & ~exclude2
    gate = EpipolarGate(F12, f1.xy, f2.xy, f2.octave, inv_sigma2_2)
    res = match_gated(f1.desc, f2.desc, rv, cv, TH_LOW, 1.0, gate=gate)
    return _with_rotation_check(res, f1.angle, f2.angle)
