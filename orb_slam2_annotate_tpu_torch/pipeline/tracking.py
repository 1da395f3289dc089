"""Per-frame tracking (port of pipeline/tracking.py): motion model with the
widen-retry, reference-keyframe fallback, local map + pose refinement.

The reference's ``lax.cond`` fallbacks are Python branches on an inlier
count read once per stage.  Relocalization runs its candidates batched
(``relocalize_candidates``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..geometry import lie
from ..geometry.camera import CameraModel, in_image, project
from ..ops import matching
from ..ops.sorting import stable_topk
from ..solvers import pose_opt
from ..worldmap import map_state as ms
from ..worldmap.map_state import MapState
from .frame import Frame

SCALE = 1.2
MAX_LOCAL_PTS = 4096
GAMMA_VEL = 1.0


def inv_sigma2(octave: torch.Tensor) -> torch.Tensor:
    return 1.0 / (SCALE ** (2.0 * octave.to(torch.float32)))


def _pose_obs_from_obs(m: MapState, frame: Frame, obs: torch.Tensor) -> pose_opt.PoseObs:
    ids = torch.clamp(obs, 0, m.P - 1).long()
    valid = (obs >= 0) & frame.valid & m.mp_valid[ids]
    return pose_opt.PoseObs(xw=m.mp_pos[ids], uv=frame.xy, ur=frame.ur,
                            inv_sigma2=inv_sigma2(frame.octave), valid=valid)


def _scatter_max_ids(n: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """[n] int32 of -1 with val scattered by max at idx (``.at[].max``)."""
    out = torch.full((n,), -1, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce(0, idx.long(), val.to(torch.int32), "amax")


def track_with_motion_model(cam: CameraModel, m: MapState, frame: Frame, last_frame: Frame,
                            last_obs: torch.Tensor, R_pred, t_pred, th: float = 15.0):
    """Project last frame's points at the predicted pose and match.
    Returns (R, t, obs [N], n_inliers)."""
    ids = torch.clamp(last_obs, 0, m.P - 1).long()
    has = (last_obs >= 0) & m.mp_valid[ids]
    xc = m.mp_pos[ids] @ R_pred.T + t_pred
    uv = project(cam, xc)
    pvalid = has & (xc[:, 2] > 0.05) & in_image(cam, uv)
    radius = th * (SCALE ** last_frame.octave.to(torch.float32))
    res = matching.search_frame_to_frame(frame, last_frame, uv, pvalid, last_frame.octave, radius)
    src = torch.where(res.matched & has, last_obs, -1)
    obs = _scatter_max_ids(frame.xy.shape[0], torch.clamp_min(res.idx, 0),
                           torch.where(res.matched, src, -1))
    pobs = _pose_obs_from_obs(m, frame, obs)
    R, t, inlier, n = pose_opt.optimize_pose(cam, R_pred, t_pred, pobs)
    obs = torch.where(inlier | ~pobs.valid, obs, -1)
    return R, t, obs, n


def track_reference_keyframe(cam: CameraModel, m: MapState, frame: Frame, kf_id: int, R0, t0):
    """Descriptor match against the reference keyframe's point features,
    then pose optimization from the last pose."""
    kf_obs = m.kf_obs[kf_id]
    kf_has = (kf_obs >= 0) & m.kf_feat_valid[kf_id] & m.mp_valid[torch.clamp(kf_obs, 0, m.P - 1).long()]
    res = matching.match_gated(m.kf_desc[kf_id], frame.desc, kf_has, frame.valid,
                               max_dist=matching.TH_LOW, ratio=0.7)
    ang2 = frame.angle[torch.clamp_min(res.idx, 0).long()]
    keep = matching.rotation_consistency(m.kf_angle[kf_id], ang2, res.matched)
    obs = _scatter_max_ids(frame.xy.shape[0], torch.clamp_min(res.idx, 0),
                           torch.where(keep, kf_obs, -1))
    pobs = _pose_obs_from_obs(m, frame, obs)
    R, t, inlier, n = pose_opt.optimize_pose(cam, R0, t0, pobs)
    obs = torch.where(inlier | ~pobs.valid, obs, -1)
    return R, t, obs, n


@dataclasses.dataclass
class LocalMapTrack:
    R: torch.Tensor
    t: torch.Tensor
    obs: torch.Tensor
    n_inliers: torch.Tensor
    n_local_kf: torch.Tensor
    mp_visible: torch.Tensor
    mp_found: torch.Tensor


def track_local_map(cam: CameraModel, m: MapState, frame: Frame, R, t, obs,
                    max_local_kf: int = 32, max_local_pts: int = MAX_LOCAL_PTS,
                    th: float = 1.0) -> LocalMapTrack:
    """SearchLocalPoints + final pose refinement."""
    P, N = m.P, frame.xy.shape[0]
    dev = m.device
    max_local_kf = min(max_local_kf, m.K)
    max_local_pts = min(max_local_pts, P)

    ids = torch.clamp(obs, 0, P - 1).long()
    cur_pts = torch.zeros(P, dtype=torch.int32, device=dev).scatter_reduce(
        0, ids, (obs >= 0).to(torch.int32), "amax").bool()
    all_ok = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    votes = (cur_pts[torch.clamp(m.kf_obs, 0, P - 1).long()] & all_ok).sum(1).float()
    votes = torch.where(m.kf_valid, votes, torch.full_like(votes, -1.0))
    top_votes, local_kf = stable_topk(votes, max_local_kf)
    kf_sel = top_votes > 0
    n_local_kf = kf_sel.sum()

    local_mask = ms.point_mask_rows(m, local_kf, kf_sel) & m.mp_valid & ~cur_pts

    xc = m.mp_pos @ R.T + t
    uv = project(cam, xc)
    cam_center = -R.T @ t
    dvec = m.mp_pos - cam_center
    dist = torch.linalg.norm(dvec, dim=-1)
    view_cos = (dvec * m.mp_normal).sum(-1) / torch.clamp_min(dist, 1e-9)
    in_frustum = ((xc[:, 2] > 0.05) & in_image(cam, uv) & (dist >= m.mp_min_dist)
                  & (dist <= m.mp_max_dist) & (view_cos > 0.5))
    cand_mask = local_mask & in_frustum

    top_oct = torch.max(torch.where(frame.valid, frame.octave, 0))
    ratio = torch.clamp_min(m.mp_max_dist / torch.clamp_min(dist, 1e-9), 1.0)
    pred_oct = torch.minimum(torch.clamp_min(
        torch.ceil(torch.log(ratio) / torch.log(torch.tensor(SCALE))).to(torch.int32), 0), top_oct)

    cand_score = torch.where(cand_mask, m.mp_first_kf.float() + 2.0, torch.zeros_like(dist))
    _, cand = stable_topk(cand_score, max_local_pts)
    cvalid = cand_mask[cand]
    r0 = torch.where(view_cos[cand] > 0.998, 2.5, 4.0)
    radius = th * r0 * (SCALE ** pred_oct[cand].to(torch.float32))
    res = matching.search_map_points(m.mp_desc[cand], cvalid, uv[cand], pred_oct[cand], radius,
                                     frame, ratio=0.8, max_dist=matching.TH_HIGH)
    newmp = torch.where(res.matched, cand.to(torch.int32), -1)
    prop = _scatter_max_ids(N, torch.clamp_min(res.idx, 0), newmp)
    obs = torch.where(obs >= 0, obs, torch.where(frame.valid, prop, -1))

    pobs = _pose_obs_from_obs(m, frame, obs)
    R2, t2, inlier, n = pose_opt.optimize_pose(cam, R, t, pobs)
    obs = torch.where(inlier | ~pobs.valid, obs, -1)

    mp_visible = m.mp_visible.index_add(0, cand, cvalid.to(torch.int32))
    found = ((obs >= 0) & inlier).to(torch.int32)
    mp_found = m.mp_found.index_add(0, torch.clamp(obs, 0, P - 1).long(), found)
    return LocalMapTrack(R2, t2, obs, n, n_local_kf, mp_visible, mp_found)


@dataclasses.dataclass
class RelocCandidates:
    """The winner of one relocalization attempt over all BoW candidates."""

    best_slot: torch.Tensor   # 0-d int (-1 = no candidate)
    best_score: torch.Tensor  # 0-d int32 PnP inliers of the winner
    R: torch.Tensor           # [3,3]
    t: torch.Tensor           # [3]
    obs: torch.Tensor         # [N] map-point ids from the winning match


def relocalize_candidates(cam: CameraModel, m: MapState, frame: Frame, vocab, db_bows,
                          gen: torch.Generator, n_hyp: int = 256) -> RelocCandidates:
    """BoW candidates with covisibility-accumulated scores, then per
    candidate a descriptor match (kernel 3, one launch for all of them), PnP
    RANSAC over all candidates at once (kernels 6 and 4) and the reference's
    gates: the candidate qualifies, >= 15 matches, a successful PnP with
    >= 15 inliers.  The candidates that fail the first two gates (one read
    of 8 flags) skip the LM polish: their score is -1 whatever it would give."""
    from ..solvers import pnp
    from ..worldmap import vocabulary as voc

    with record_function("reloc/bow"):
        bow = voc.bow_vector(vocab, frame.desc, frame.valid)
        slots, ok = voc.detect_relocalization_candidates(voc.KeyFrameDatabase(db_bows), bow,
                                                         m.kf_valid, ms.covisibility(m))
    with record_function("reloc/match"):
        kf_obs, kf_desc = m.kf_obs[slots], m.kf_desc[slots]              # [C,N], [C,N,16]
        kf_has = (kf_obs >= 0) & m.kf_feat_valid[slots] & m.mp_valid[
            torch.clamp(kf_obs, 0, m.P - 1).long()]
        # all candidates in one matcher launch, the frame's descriptors shared
        res = matching.match_gated(kf_desc, frame.desc, kf_has, frame.valid,
                                   max_dist=matching.TH_LOW, ratio=0.75)   # [C,N]
        obs = torch.full(kf_obs.shape, -1, dtype=torch.int32, device=m.device).scatter_reduce(
            1, torch.clamp_min(res.idx, 0).long(), torch.where(res.matched & kf_has, kf_obs, -1),
            "amax")
        pvalid = (obs >= 0) & frame.valid[None, :]
        gate = ok & (pvalid.sum(1) >= 15)
    with record_function("reloc/sample"):
        samples = pnp.sample_pnp_sets(gen, pvalid, n_hyp)
    r = pnp.pnp_from_samples(cam, samples, m.mp_pos[torch.clamp(obs, 0, m.P - 1).long()], frame.xy,
                             pvalid, min_inliers=15,
                             polish=torch.nonzero(gate).flatten().tolist())
    scores = torch.where(gate & r.success, r.n_inliers, -1).to(torch.int32)
    best = torch.argmax(scores)
    found = scores[best] > 0
    return RelocCandidates(best_slot=torch.where(found, slots[best], -1), best_score=scores[best],
                           R=r.R[best], t=r.t[best], obs=obs[best])


@dataclasses.dataclass
class TrackStep:
    R: torch.Tensor
    t: torch.Tensor
    obs: torch.Tensor
    mp_visible: torch.Tensor
    mp_found: torch.Tensor
    n_pre: int
    n_local: int
    n_local_kf: int
    vel_R: torch.Tensor
    vel_t: torch.Tensor
    R_cr: torch.Tensor
    t_cr: torch.Tensor


def track_frame(cam: CameraModel, m: MapState, frame: Frame, last_frame: Frame,
                last_obs: torch.Tensor, R_last, t_last, vel_R, vel_t, has_vel: bool,
                ref_kf: int) -> TrackStep:
    """Motion model (with widen-retry) -> reference keyframe when it finds
    fewer than 20 inliers -> local map -> velocity and pose relative to the
    reference keyframe."""
    N = frame.xy.shape[0]
    if has_vel:
        R_pred, t_pred = lie.se3_compose(vel_R, vel_t, R_last, t_last)
        R1, t1, obs1, n1 = track_with_motion_model(cam, m, frame, last_frame, last_obs,
                                                   R_pred, t_pred)
        n1 = int(n1)
        if n1 < 20:
            R1, t1, obs1, n1 = track_with_motion_model(cam, m, frame, last_frame, last_obs,
                                                       R_pred, t_pred, th=30.0)
            n1 = int(n1)
    else:
        R1, t1, obs1, n1 = (R_last, t_last,
                            torch.full((N,), -1, dtype=torch.int32, device=m.device), -1)
    if n1 < 20:
        R1, t1, obs1, n1 = track_reference_keyframe(cam, m, frame, ref_kf, R_last, t_last)
        n1 = int(n1)

    res = track_local_map(cam, m, frame, R1, t1, obs1)
    Ri, ti = lie.se3_inverse(R_last, t_last)
    vR_raw, vt_raw = lie.se3_compose(res.R, res.t, Ri, ti)
    vR, vt = lie.se3_exp(GAMMA_VEL * lie.se3_log(vR_raw, vt_raw))
    Rri, tri = lie.se3_inverse(m.kf_R[ref_kf], m.kf_t[ref_kf])
    Rcr, tcr = lie.se3_compose(res.R, res.t, Rri, tri)
    stats = torch.stack([res.n_inliers.to(torch.int32), res.n_local_kf.to(torch.int32)]).tolist()
    return TrackStep(res.R, res.t, res.obs, res.mp_visible, res.mp_found, n1, stats[0], stats[1],
                     vR, vt, Rcr, tcr)
