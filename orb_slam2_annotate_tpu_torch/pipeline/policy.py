"""Keyframe decision and the bootstrap maps, monocular and RGB-D / stereo
(port of pipeline/policy.py)."""

from __future__ import annotations

import torch

from ..geometry.camera import CameraModel
from ..ops.sorting import nanmedian
from ..solvers.initializer import InitResult
from ..worldmap import map_state as ms
from .frame import Frame


def need_new_keyframe(since: int, n_local: int, peak: int, *, min_frames: int,
                      max_frames: int, ref_ratio: float, min_track: int) -> bool:
    """NeedNewKeyFrame (Tracking.cc:1075): too long since the last keyframe,
    or the tracked count decayed well below its in-window peak."""
    c1 = since >= max_frames
    c2 = n_local < ref_ratio * max(peak, 1)
    return (since >= min_frames) and (c1 or c2) and (n_local > min_track)


def build_mono_init_map(m: ms.MapState, cam: CameraModel, f0: Frame, frame: Frame,
                        init: InitResult, match_idx: torch.Tensor,
                        init_fid: int, init_ts: float, frame_id: int, ts: float):
    """Two-keyframe bootstrap map: scale to median depth 1, insert KF0
    (identity) and KF1, one point per good triangulation (slot = KF0
    feature index), stats, then the initial two-view BA.
    Returns (map, obs1 [N] frame feature -> point id)."""
    from . import local_mapping as lm

    N, P = f0.xy.shape[0], m.P
    dev = m.device
    good, X = init.good, init.points
    z = torch.where(good & (X[:, 2] > 0), X[:, 2], torch.full_like(X[:, 2], float("nan")))
    med = torch.nan_to_num(nanmedian(z), nan=1.0)
    med = torch.where(med > 1e-6, med, torch.ones_like(med))
    X = X / med
    t1 = init.t / med

    mp_ids = torch.arange(N, dtype=torch.int32, device=dev)
    obs0 = torch.where(good, mp_ids, -1)
    obs1 = torch.full((N,), -1, dtype=torch.int32, device=dev).scatter_reduce(
        0, torch.clamp_min(match_idx, 0).long(), obs0, "amax")

    m = ms.insert_keyframe(m, 0, torch.eye(3, device=dev), torch.zeros(3, device=dev), init_fid,
                           init_ts, f0.xy, f0.ur, f0.depth, f0.octave, f0.angle, f0.desc,
                           f0.valid, obs0)
    m = ms.insert_keyframe(m, 1, init.R, t1, frame_id, ts, frame.xy, frame.ur, frame.depth,
                           frame.octave, frame.angle, frame.desc, frame.valid, obs1)
    mp_valid = torch.zeros(P, dtype=torch.bool, device=dev)
    mp_valid[:N] = good
    mp_pos = torch.zeros(P, 3, device=dev)
    mp_pos[:N] = torch.where(good[:, None], X, torch.zeros_like(X))
    m = m.replace(mp_pos=mp_pos, mp_valid=mp_valid,
                  mp_first_kf=torch.where(mp_valid, 0, m.mp_first_kf).to(torch.int32))
    m = ms.update_mappoint_stats_touched(m, mp_valid)
    m = lm.local_bundle_adjustment(m, cam, 1)
    return ms.update_mappoint_stats_touched(m, mp_valid), obs1


def build_depth_init_map(m: ms.MapState, cam: CameraModel, frame: Frame, slot: int,
                         frame_id: int, ts: float, max_depth: float) -> ms.MapState:
    """RGB-D / stereo bootstrap: one keyframe at the origin in `slot`, a
    point from every feature with depth in (0, max_depth), and the stats of
    those points only (mp_first_kf holds the keyframe counter, n_kf - 1)."""
    from . import local_mapping as lm

    dev = m.device
    obs = torch.full((frame.xy.shape[0],), -1, dtype=torch.int32, device=dev)
    m = lm.insert_keyframe_from_frame(m, frame, slot, torch.eye(3, device=dev),
                                      torch.zeros(3, device=dev), obs, frame_id, ts)
    m = lm.create_depth_mappoints(m, cam, slot, max_depth)
    return ms.update_mappoint_stats_touched(m, m.mp_first_kf == m.n_kf - 1)
