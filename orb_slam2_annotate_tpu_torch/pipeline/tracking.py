"""Per-frame tracking (port of pipeline/tracking.py): motion model with the
widen-retry, reference-keyframe fallback, local map + pose refinement.

In ``track_frame`` the reference's ``lax.cond`` fallbacks are Python
branches on an inlier count read once per stage.  ``track_frame_device``,
the pipelined path's step, reads nothing back: it runs every fallback and
picks on the device.  Relocalization runs its candidates batched
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
from ..parallel import points as pts
from ..solvers import pose_opt
from ..worldmap import map_state as ms
from ..worldmap.map_state import MapState
from .frame import Frame

SCALE = 1.2
MAX_LOCAL_PTS = 4096
GAMMA_VEL = 1.0


def inv_sigma2(octave: torch.Tensor) -> torch.Tensor:
    return ms.inv_level_sigma2(octave, SCALE)


def _pose_obs_from_obs(m: MapState, frame: Frame, obs: torch.Tensor) -> pose_opt.PoseObs:
    mp_valid, mp_pos = ms.point_rows(m, obs, "mp_valid", "mp_pos")
    valid = (obs >= 0) & frame.valid & mp_valid
    return pose_opt.PoseObs(xw=mp_pos, uv=frame.xy, ur=frame.ur,
                            inv_sigma2=inv_sigma2(frame.octave), valid=valid)


def _scatter_max_ids(n: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """[n] int32 of -1 with val scattered by max at idx (``.at[].max``)."""
    out = torch.full((n,), -1, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce(0, idx.long(), val.to(torch.int32), "amax")


def track_with_motion_model(cam: CameraModel, m: MapState, frame: Frame, last_frame: Frame,
                            last_obs: torch.Tensor, R_pred, t_pred, th: float = 15.0):
    """Project last frame's points at the predicted pose and match.
    Returns (R, t, obs [N], n_inliers)."""
    mp_valid, mp_pos = ms.point_rows(m, last_obs, "mp_valid", "mp_pos")
    has = (last_obs >= 0) & mp_valid
    xc = mp_pos @ R_pred.T + t_pred
    uv = project(cam, xc)
    pvalid = has & (xc[:, 2] > 0.05) & in_image(cam, uv)
    radius = ms.scaled_radius(th, last_frame.octave, SCALE)
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
    kf_has = (kf_obs >= 0) & m.kf_feat_valid[kf_id] & ms.point_rows(m, kf_obs, "mp_valid")[0]
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
    """SearchLocalPoints + final pose refinement.  On a split map the
    projection and frustum tests run on each rank's own points, the
    keyframe votes are summed over the ranks, the candidates are the top
    ``max_local_pts`` over all ranks and their rows are gathered before the
    matcher (kernel 3) and the pose LM (kernel 4) run on every rank."""
    P, N = m.P, frame.xy.shape[0]
    mesh = m.mesh
    max_local_kf = min(max_local_kf, m.K)
    max_local_pts = min(max_local_pts, P)

    ids = torch.clamp(obs, 0, P - 1)
    cur_pts = pts.scatter_owned(mesh, m.P_local, ids, obs >= 0)
    all_ok, all_loc = pts.owned_rows(m.mesh, torch.clamp(m.kf_obs, max=P - 1),
                                     m.kf_feat_valid & m.kf_valid[:, None])
    votes = pts.sum_points(mesh, (cur_pts[all_loc] & all_ok).sum(1)).float()
    votes = torch.where(m.kf_valid, votes, torch.full_like(votes, -1.0))
    top_votes, local_kf = stable_topk(votes, max_local_kf)
    kf_sel = top_votes > 0
    n_local_kf = kf_sel.sum()

    local_mask = ms.point_mask_rows(m, local_kf, kf_sel) & m.mp_valid & ~cur_pts

    xc = m.mp_pos @ R.T + t
    uv = project(cam, xc)
    cam_center = -R.T @ t
    dvec = m.mp_pos - cam_center
    # the gates in the CPU's bits on every device (lie.norm3, the dot's sums in
    # order, ms.predict_octave), as local mapping's fuse takes them
    dist = lie.norm3(dvec)
    dn = dvec * m.mp_normal
    view_cos = (dn[:, 0] + dn[:, 1] + dn[:, 2]) / torch.clamp_min(dist, 1e-9)
    in_frustum = ((xc[:, 2] > 0.05) & in_image(cam, uv) & (dist >= m.mp_min_dist)
                  & (dist <= m.mp_max_dist) & (view_cos > 0.5))
    cand_mask = local_mask & in_frustum

    top_oct = torch.max(torch.where(frame.valid, frame.octave, 0))
    pred_oct = ms.predict_octave(m.mp_max_dist, dist, top_oct, SCALE)

    cand_score = torch.where(cand_mask, m.mp_first_kf.float() + 2.0, torch.zeros_like(dist))
    _, cand = pts.topk_points(mesh, cand_score, max_local_pts)
    cvalid, c_cos, c_oct, c_uv, c_desc = pts.gather_rows(mesh, cand, cand_mask, view_cos,
                                                          pred_oct, uv, m.mp_desc)
    r0 = torch.where(c_cos > 0.998, 2.5, 4.0)
    radius = ms.scaled_radius(th * r0, c_oct, SCALE)
    res = matching.search_map_points(c_desc, cvalid, c_uv, c_oct, radius,
                                     frame, ratio=0.8, max_dist=matching.TH_HIGH)
    newmp = torch.where(res.matched, cand.to(torch.int32), -1)
    prop = _scatter_max_ids(N, torch.clamp_min(res.idx, 0), newmp)
    obs = torch.where(obs >= 0, obs, torch.where(frame.valid, prop, -1))

    pobs = _pose_obs_from_obs(m, frame, obs)
    R2, t2, inlier, n = pose_opt.optimize_pose(cam, R, t, pobs)
    obs = torch.where(inlier | ~pobs.valid, obs, -1)

    mp_visible = pts.index_add_rows(mesh, m.mp_visible, cand, cvalid.to(torch.int32))
    found = ((obs >= 0) & inlier).to(torch.int32)
    mp_found = pts.index_add_rows(mesh, m.mp_found, torch.clamp(obs, 0, P - 1), found)
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
        kf_has = (kf_obs >= 0) & m.kf_feat_valid[slots] & ms.point_rows(m, kf_obs, "mp_valid")[0]
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
    r = pnp.pnp_from_samples(cam, samples, ms.point_rows(m, obs, "mp_pos")[0], frame.xy,
                             pvalid, min_inliers=15,
                             polish=torch.nonzero(gate).flatten().tolist())
    scores = torch.where(gate & r.success, r.n_inliers, -1).to(torch.int32)
    best = torch.argmax(scores)
    found = scores[best] > 0
    return RelocCandidates(best_slot=torch.where(found, slots[best], -1), best_score=scores[best],
                           R=r.R[best], t=r.t[best], obs=obs[best])


@dataclasses.dataclass
class TrackStep:
    """One frame's tracking result; the counts are ints from ``track_frame``
    and 0-d int32 tensors from ``track_frame_device``."""

    R: torch.Tensor
    t: torch.Tensor
    obs: torch.Tensor
    mp_visible: torch.Tensor
    mp_found: torch.Tensor
    n_pre: int | torch.Tensor
    n_local: int | torch.Tensor
    n_local_kf: int | torch.Tensor
    vel_R: torch.Tensor
    vel_t: torch.Tensor
    R_cr: torch.Tensor
    t_cr: torch.Tensor

    def host_bundle(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(stats [3] int32: n_pre, n_local, n_local_kf; poses [3,12] f32 rows
        R|t, vel_R|vel_t, R_cr|t_cr), for one copy each to the host."""
        stats = torch.stack([torch.as_tensor(n, device=self.R.device).to(torch.int32)
                             for n in (self.n_pre, self.n_local, self.n_local_kf)])
        poses = torch.stack([torch.cat([R.reshape(9), t]) for R, t in
                             ((self.R, self.t), (self.vel_R, self.vel_t), (self.R_cr, self.t_cr))])
        return stats, poses


def _finish_step(cam: CameraModel, m: MapState, frame: Frame, R_last, t_last, ref_kf: int,
                 R1, t1, obs1):
    """Local map from (R1, t1, obs1), then the velocity and the pose relative
    to the reference keyframe: (LocalMapTrack, vel_R, vel_t, R_cr, t_cr)."""
    res = track_local_map(cam, m, frame, R1, t1, obs1)
    Ri, ti = lie.se3_inverse(R_last, t_last)
    vR_raw, vt_raw = lie.se3_compose(res.R, res.t, Ri, ti)
    vR, vt = lie.se3_exp(GAMMA_VEL * lie.se3_log(vR_raw, vt_raw))
    Rri, tri = lie.se3_inverse(m.kf_R[ref_kf], m.kf_t[ref_kf])
    Rcr, tcr = lie.se3_compose(res.R, res.t, Rri, tri)
    return res, vR, vt, Rcr, tcr


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

    res, vR, vt, Rcr, tcr = _finish_step(cam, m, frame, R_last, t_last, ref_kf, R1, t1, obs1)
    stats = torch.stack([res.n_inliers.to(torch.int32), res.n_local_kf.to(torch.int32)]).tolist()
    return TrackStep(res.R, res.t, res.obs, res.mp_visible, res.mp_found, n1, stats[0], stats[1],
                     vR, vt, Rcr, tcr)


def _pick(cond: torch.Tensor, a: tuple, b: tuple) -> tuple:
    """Elementwise a if cond else b over (R, t, obs, n)."""
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def track_frame_device(cam: CameraModel, m: MapState, frame: Frame, last_frame: Frame,
                       last_obs: torch.Tensor, R_last, t_last, vel_R, vel_t, has_vel: bool,
                       ref_kf: int) -> TrackStep:
    """``track_frame`` without a host read, as the reference's ``lax.cond``s
    run: with a velocity, the 15-px and the widened 30-px motion-model
    searches both run, then the reference-keyframe track; the branch is
    picked on the device (the widened result when the first finds fewer than
    20 inliers, the reference keyframe's when that one does too), so R, t
    and obs are those of ``track_frame``.  Each search is one matcher and
    one pose-LM launch: four of each a frame with a velocity, two without.
    The counts are 0-d int32 tensors."""
    if has_vel:
        R_pred, t_pred = lie.se3_compose(vel_R, vel_t, R_last, t_last)
        first = track_with_motion_model(cam, m, frame, last_frame, last_obs, R_pred, t_pred)
        wide = track_with_motion_model(cam, m, frame, last_frame, last_obs, R_pred, t_pred,
                                       th=30.0)
        mm = _pick(first[3] < 20, wide, first)
        ref = track_reference_keyframe(cam, m, frame, ref_kf, R_last, t_last)
        R1, t1, obs1, n1 = _pick(mm[3] < 20, ref, mm)
    else:
        R1, t1, obs1, n1 = track_reference_keyframe(cam, m, frame, ref_kf, R_last, t_last)
    res, vR, vt, Rcr, tcr = _finish_step(cam, m, frame, R_last, t_last, ref_kf, R1, t1, obs1)
    return TrackStep(res.R, res.t, res.obs, res.mp_visible, res.mp_found, n1.to(torch.int32),
                     res.n_inliers.to(torch.int32), res.n_local_kf.to(torch.int32), vR, vt, Rcr, tcr)
