"""Keyframe decision and the bootstrap maps, monocular and RGB-D / stereo
(port of pipeline/policy.py)."""

from __future__ import annotations

import torch

from ..geometry.camera import CameraModel
from ..ops.sorting import nanmedian
from ..parallel import points as pts
from ..solvers.initializer import InitResult
from ..worldmap import map_state as ms
from .frame import Frame


def need_new_keyframe(since, n_local, peak, *, min_frames: int, max_frames: int,
                      ref_ratio: float, min_track: int):
    """NeedNewKeyFrame (Tracking.cc:1075): too long since the last keyframe,
    or the tracked count decayed well below its in-window peak.  Host ints
    give a bool, device scalars a 0-d bool tensor."""
    peak1 = torch.clamp_min(peak, 1) if torch.is_tensor(peak) else max(peak, 1)
    c1 = since >= max_frames
    c2 = n_local < ref_ratio * peak1
    return (since >= min_frames) & (c1 | c2) & (n_local > min_track)


def keyframe_bows(vocab, m: ms.MapState) -> torch.Tensor:
    """[K, W] BoW rows of every valid keyframe, zeros elsewhere: the
    keyframe database rebuilt from a map.  All K x N descriptors go through
    one word assignment (kernel 5 on the card)."""
    from ..worldmap import vocabulary as voc

    bows = voc.bow_rows(vocab, m.kf_desc, m.kf_feat_valid & m.kf_valid[:, None])
    return torch.where(m.kf_valid[:, None], bows, 0.0)


def build_mono_init_map(m: ms.MapState, cam: CameraModel, f0: Frame, frame: Frame,
                        init: InitResult, match_idx: torch.Tensor,
                        init_fid: int, init_ts: float, frame_id: int, ts: float):
    """Two-keyframe bootstrap map: scale to median depth 1, insert KF0
    (identity) and KF1, one point per good triangulation (slot = KF0
    feature index), stats, then the initial two-view BA.
    Returns (map, obs1 [N] frame feature -> point id)."""
    from . import local_mapping as lm

    N = f0.xy.shape[0]
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
    # point n at global id n, written by the rank that owns it
    ids = torch.arange(N, device=dev)
    mp_valid = pts.put_rows(m.mesh, torch.zeros_like(m.mp_valid), ids, good)
    mp_pos = pts.put_rows(m.mesh, torch.zeros_like(m.mp_pos), ids,
                          torch.where(good[:, None], X, torch.zeros_like(X)))
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
