"""Parity of the port's fuse with the JAX package: the fuse core on a
constructed double loser, ``fuse_neighbors`` on the new keyframe (with
and without the stats refresh) and on older ones,
``create_new_mappoints`` with its stats refresh, and the duplicate
same-keyframe observations that fuse's merges leave (which the reference's
``covis_rows`` and tracking votes count twice, and the port with them).

The state is the JAX System's after 14 frames of the slice (PlaneScene
seed 1, 320x240, 512 features, 4 levels, as tests/test_torch_pipeline.py),
with frame 14 tracked, inserted as a keyframe, its recent points culled and
new points triangulated with the stats refresh, in the reference.

Tolerances: integer fields (observations, validity, descriptors) exactly
equal; float fields (normals, depth bands) within 1e-4, as the chain's stats
refresh in tests/test_torch_pipeline.py, and 1e-3 after triangulation, as
its triangulation.  The fuse tests start from the reference's triangulated
map.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import synthetic
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System
from orb_slam2_annotate_tpu.pipeline import frame as jfr
from orb_slam2_annotate_tpu.pipeline import local_mapping as jlm
from orb_slam2_annotate_tpu.pipeline import tracking as jtk
from orb_slam2_annotate_tpu.worldmap import map_state as jms
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.pipeline import local_mapping as tlm
from orb_slam2_annotate_tpu_torch.pipeline import tracking as ttk
from orb_slam2_annotate_tpu_torch.worldmap import map_state as tms

from _fuse_cases import double_loser_case

torch.set_num_threads(1)

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CAM = CameraModel.create(**ARGS)
TCAM = TCam.create(**ARGS)
SLICE = dict(enable_loop_closing=False, enable_relocalization=False, enable_kf_culling=False,
             enable_fuse=False, async_depth=0, shard_points=False)


def nd(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def to_jax(m_t):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_to_numpy(m_t).items()})


def assert_map(m_t, m_j, atol=1e-4):
    got = convert.map_state_to_numpy(m_t)
    for k, ref in nd(m_j).items():
        if np.issubdtype(ref.dtype, np.floating):
            fin = np.isfinite(ref)
            np.testing.assert_array_equal(np.isfinite(got[k]), fin, err_msg=k)
            np.testing.assert_allclose(got[k][fin], ref[fin], atol=atol, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref, err_msg=k)


@pytest.fixture(scope="module")
def triangulated():
    """(reference map, port map, slot): frame 14 inserted as a keyframe,
    recent points culled, new points triangulated with the stats refresh;
    both maps from the same culled map."""
    cfg = SlamConfig(n_features=512, n_levels=4, max_kf=16, max_mp=2048, max_frames_between_kf=4,
                     init_min_matches=60, **SLICE)
    slam = System(CAM, cfg)
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(15, step=0.06)
    for k, (R, t) in enumerate(poses[:14]):
        slam.track_mono(scene.render(CAM, R, t, h=240, w=320)[0], k / 30.0)
    assert slam.state == "OK" and slam.vel is not None
    frame = jfr.make_frame_mono(jnp.asarray(scene.render(CAM, *poses[14], h=240, w=320)[0]), CAM,
                                cfg.extractor)
    step = jtk.track_frame(CAM, slam.map, frame, slam.last_frame, slam.last_obs, slam.R, slam.t,
                           slam.vel[0], slam.vel[1], jnp.asarray(True),
                           jnp.asarray(slam.ref_kf, jnp.int32))
    jm, slot = jlm.insert_keyframe_from_frame(slam.map, frame, step.R, step.t, step.obs, 14,
                                              14 / 30.0, update_stats=False)
    slot = int(slot)
    jc = jlm.cull_recent_mappoints(jm)
    tc = convert.map_state_from_numpy(nd(jc), device="cpu")
    ref = jlm.create_new_mappoints(jc, CAM, jnp.asarray(slot), update_stats=True)
    got = tlm.create_new_mappoints(tc, TCAM, slot, update_stats=True)
    return ref, got, slot


def test_create_new_mappoints_with_stats_refresh(triangulated):
    ref, got, _ = triangulated
    assert_map(got, ref, 1e-3)


@pytest.fixture(scope="module")
def fuse_input(triangulated):
    """The reference's triangulated map in both packages, and the slot."""
    ref, _, slot = triangulated
    return ref, convert.map_state_from_numpy(nd(ref), device="cpu"), slot


def test_double_loser_keeps_the_reference_winner():
    # one point loses in two targets to two winners: the reference's CPU
    # scatter keeps the later pair's (point 2), and so must the port
    cam, m, targets, tgt_ok, src = double_loser_case("cpu")
    got = tlm._fuse_targets_core(m, cam, targets, tgt_ok, src)
    ref = jlm._fuse_targets_core(to_jax(m), CameraModel.create(**ARGS), jnp.asarray(targets.numpy()),
                                 jnp.asarray(tgt_ok.numpy()), jnp.asarray(src.numpy()))
    np.testing.assert_array_equal(got.kf_obs.numpy(), np.asarray(ref.kf_obs))
    np.testing.assert_array_equal(got.mp_valid.numpy(), np.asarray(ref.mp_valid))
    assert got.kf_obs[2, 1] == 2 and not got.mp_valid[0] and got.mp_valid[1:3].all()


@pytest.mark.parametrize("which", ["new", "new_then_refresh", "previous", "first"])
def test_fuse_neighbors(fuse_input, which):
    # the new keyframe's fuse, as the chain runs it (no stats refresh of its
    # own) and followed by the chain's windowed refresh (the reference's
    # update_stats=True); and the fuse of an older keyframe with its own
    # covisible neighbours
    jm, tm, slot = fuse_input
    target = {"previous": slot - 1, "first": 0}.get(which, slot)
    refresh = which == "new_then_refresh"
    ref = jlm.fuse_neighbors(jm, CAM, jnp.asarray(target), update_stats=refresh)
    got = tlm.fuse_neighbors(tm, TCAM, target)
    if refresh:
        got = tms.update_mappoint_stats_touched(got, tlm.window_touched_points(got, target))
    assert_map(got, ref)
    # the fuse acts: associations added and points merged
    added = int(((tm.kf_obs < 0) & (got.kf_obs >= 0)).sum())
    merged = int((tm.mp_valid & ~got.mp_valid).sum())
    assert added > 0 and merged > 0, (added, merged)


def test_fuse_leaves_duplicate_observations_that_votes_count_twice(fuse_input):
    # fuse's merge remap can leave one keyframe observing a point at two
    # features; covis_rows and the tracking votes count such a point twice,
    # as the reference does (ROADMAP.md §3)
    _, tm, slot = fuse_input
    got = tlm.fuse_neighbors(tm, TCAM, slot)
    m = got.replace(kf_obs=got.kf_obs.clone())
    row = m.kf_obs[slot]
    first, second = torch.nonzero(row >= 0).flatten()[:2].tolist()
    m.kf_obs[slot, second] = row[first]              # a duplicate of the kind fuse leaves
    rows = torch.tensor([slot, (slot + 1) % m.K])
    np.testing.assert_array_equal(
        tms.covis_rows(m, rows, torch.ones(2, dtype=torch.bool)).numpy(),
        np.asarray(jms.covis_rows(to_jax(m), jnp.asarray(rows.numpy()), jnp.ones(2, bool))))
    # the tracking votes: a frame observing that point votes for `slot` twice
    obs = torch.full((m.N,), -1, dtype=torch.int32)
    obs[0] = row[first]
    frame = tlm._kf_frame(m, slot)
    res = ttk.track_local_map(TCAM, m, frame, m.kf_R[slot], m.kf_t[slot], obs)
    jframe = jfr.Frame(**{k: jnp.asarray(v) for k, v in convert.frame_to_numpy(frame).items()})
    ref = jtk.track_local_map(CAM, to_jax(m), jframe, jnp.asarray(m.kf_R[slot].numpy()),
                              jnp.asarray(m.kf_t[slot].numpy()), jnp.asarray(obs.numpy()))
    assert int(res.n_local_kf) == int(ref.n_local_kf)
    np.testing.assert_array_equal(res.obs.numpy(), np.asarray(ref.obs))
    cur = torch.zeros(m.P, dtype=torch.bool)
    cur[row[first]] = True
    ok = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    votes = (cur[m.kf_obs.clamp(0, m.P - 1).long()] & ok).sum(1)
    assert votes[slot] == 2
