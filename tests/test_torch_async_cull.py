"""Pipelined tracking's deferred keyframe cull: with ``async_depth=2`` the
cull info of a keyframe is copied to the host without waiting and applied
at the next keyframe (or by ``flush``), a keyframe late.

The slice's plane rarely gives a keyframe whose points 3 others see, so at
frame 16 one keyframe row (the third newest) is copied into three free
slots, as ``redundant_map`` of tests/test_torch_relocalization.py does:
the next keyframe chain then holds 9 keyframes and culls copies.  The run
is the slice (PlaneScene seed 1, 320x240, 512 features, 4 levels, 24
frames, a keyframe at least every 4 frames), synchronous, pipelined with
the ready test as it is, and pipelined with it held at "not ready".

Tolerances: the drops applied through the deferred path only, the host
mirror of the valid keyframes equal to the map's, every tracked frame's
record on a valid keyframe, every frame from initialization on tracked as
in the synchronous run, and the Sim3-aligned ATE <= max(1.5 x ATE_sync,
ATE_sync + 0.01 m) and < 0.08 m, as ``test_slice_matches_jax_system``.
"""

import sys

import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.io import evaluation as teval
from orb_slam2_annotate_tpu_torch.io import synthetic as tsyn
from orb_slam2_annotate_tpu_torch.pipeline import System as TSystem
from orb_slam2_annotate_tpu_torch.pipeline import mono_slice_config

torch.set_num_threads(1)

TCAM = TCam.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
N_FRAMES = 24
PLANT_AT = 16
SIZES = dict(n_features=512, n_levels=4, max_kf=64, max_mp=8192, max_frames_between_kf=4,
             init_min_matches=60)


def plant_copies(slam):
    """Copy the third newest keyframe's row into three free slots."""
    m = slam.map
    fid = np.where(slam._kf_valid_host, m.kf_frame_id.numpy(), -1)
    original = int(np.argsort(-fid, kind="stable")[2])
    free = np.flatnonzero(~slam._kf_valid_host)[:3]
    slam.map = m.replace(**{f: getattr(m, f).index_copy(0, torch.as_tensor(free),
                                                        getattr(m, f)[[original] * 3])
                            for f in m.__dataclass_fields__ if f.startswith("kf_")})
    slam._kf_valid_host[free] = True


@pytest.fixture(scope="module")
def runs():
    """name -> (System after flush, [(caller, culled slots)] of every cull
    info applied)."""
    scene = tsyn.PlaneScene(seed=1)
    poses = tsyn.orbit_trajectory(N_FRAMES, step=0.06)
    images = [scene.render(TCAM, R, t, h=240, w=320)[0] for R, t in poses]
    out = {}
    for name, depth, held in (("sync", 0, False), ("ready", 2, False), ("held", 2, True)):
        slam = TSystem(TCAM, mono_slice_config(async_depth=depth, **SIZES), device="cpu")
        if held:
            slam._ready = lambda e: False
        applied, real = [], slam._apply_cull_info

        def spy(info, applied=applied, real=real):
            applied.append((sys._getframe(1).f_code.co_name, info.slots[info.ok].tolist()))
            return real(info)

        slam._apply_cull_info = spy
        for k, img in enumerate(images):
            if k == PLANT_AT:
                plant_copies(slam)
            slam.track_mono(img, k / 30.0)
        slam.flush()
        out[name] = (slam, applied)
    return poses, out


def ate(slam, poses):
    traj = dict(slam.frame_trajectory())
    ids = [k for k, T in traj.items() if T is not None]
    est = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids])
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids])
    return teval.ate_rmse(est, gt, with_scale=True)[0], len(ids)


@pytest.mark.parametrize("name", ["sync", "ready", "held"])
def test_cull_is_applied(runs, name):
    _, out = runs
    slam, applied = out[name]
    # the synchronous chain applies its cull info at once; the pipelined one
    # only through the deferred read, and copies were dropped
    caller = "_create_keyframe" if name == "sync" else "_resolve_pending"
    assert applied and {c for c, _ in applied} == {caller}, applied
    assert sum(len(s) for _, s in applied) >= 2, applied
    assert slam._pending_cull is None and not slam._inflight
    np.testing.assert_array_equal(slam._kf_valid_host, slam.map.kf_valid.numpy())
    # every tracked frame's record was moved off the culled keyframes
    assert all(slam._kf_valid_host[r.ref_kf_slot] for r in slam.records if not r.lost)


@pytest.mark.parametrize("name", ["ready", "held"])
def test_pipelined_cull_run_matches_sync(runs, name):
    poses, out = runs
    slam, ref = out[name][0], out["sync"][0]
    assert slam.state == "OK" and ref.state == "OK"
    assert [r.frame_id for r in slam.records] == list(range(N_FRAMES))
    ate_t, n_t = ate(slam, poses)
    ate_r, n_r = ate(ref, poses)
    # every frame from initialization (frame 8 here) on is tracked, as in the synchronous run
    assert n_t == n_r >= N_FRAMES - 8, (n_t, n_r)
    assert ate_t <= max(1.5 * ate_r, ate_r + 0.01), (ate_t, ate_r)
    assert ate_t < 0.08
