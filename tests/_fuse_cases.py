"""Constructed fuse inputs shared by the CPU tests and ``chip_smoke.py``
(which holds the fuse core on the card to its CPU result on them)."""

import dataclasses

import torch

from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
from orb_slam2_annotate_tpu_torch.worldmap import map_state


def double_loser_case(device):
    """A map where one point loses two fuse merges to two different winners:
    (camera, map, targets, tgt_ok, src_masks) for
    ``local_mapping._fuse_targets_core``.  Point 0 (one observation, by
    keyframe 2) projects onto feature 0 of keyframes 0 and 1, whose
    descriptor is its own; there keyframe 0 observes point 1 and keyframe 1
    point 2, both 5 mm from point 0 at 2 m and seen twice (keyframe 3 also
    observes them), so point 0 loses to point 1 in target 0 and to point 2 in
    target 1.  The reference's CPU scatter keeps the later pair's winner,
    point 2."""
    cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    K, P, N = 4, 16, 8
    m = map_state.empty_map(K, P, N)
    gen = torch.Generator().manual_seed(5)
    words = lambda *shape: torch.randint(-2**31, 2**31 - 1, shape, generator=gen, dtype=torch.int64
                                         ).to(torch.int32)
    mp_pos = torch.zeros(P, 3)
    mp_pos[:3] = torch.tensor([[0.0, 0.0, 2.0], [0.005, 0.0, 2.0], [-0.005, 0.0, 2.0]])
    mp_valid = torch.zeros(P, dtype=torch.bool)
    mp_valid[:3] = True
    mp_desc = words(P, 16)
    kf_desc = words(K, N, 16)
    kf_desc[0, 0] = kf_desc[1, 0] = mp_desc[0]
    # every feature at its own place, feature 0 where point 0 projects
    kf_xy = torch.stack([torch.linspace(20.0, 300.0, N), torch.full((N,), 200.0)], -1).repeat(K, 1, 1)
    kf_xy[:2, 0] = torch.tensor([160.0, 120.0])
    kf_obs = torch.full((K, N), -1, dtype=torch.int32)
    kf_obs[0, 0], kf_obs[1, 0], kf_obs[2, 1], kf_obs[3, 1], kf_obs[3, 2] = 1, 2, 0, 1, 2
    m = m.replace(kf_valid=torch.ones(K, dtype=torch.bool), kf_xy=kf_xy,
                  kf_octave=torch.zeros(K, N, dtype=torch.int32), kf_desc=kf_desc,
                  kf_feat_valid=torch.ones(K, N, dtype=torch.bool), kf_obs=kf_obs,
                  mp_pos=mp_pos, mp_valid=mp_valid, mp_desc=mp_desc,
                  mp_normal=torch.tensor([0.0, 0.0, 1.0]).repeat(P, 1),
                  mp_min_dist=torch.full((P,), 0.1), mp_max_dist=torch.full((P,), 10.0),
                  n_kf=torch.tensor(K, dtype=torch.int32))
    m = map_state.MapState(**{f.name: getattr(m, f.name).to(device) for f in dataclasses.fields(m)})
    targets = torch.tensor([0, 1], device=device)
    return (cam, m, targets, torch.ones(2, dtype=torch.bool, device=device),
            m.mp_valid[None].expand(2, P).contiguous())
