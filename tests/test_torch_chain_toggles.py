"""Parity of the port's keyframe chain with the JAX package's under each of
its stage toggles (fuse, recent-point cull, local BA, the stats refresh in
triangulation), on the state of tests/test_torch_pipeline.py: the JAX
System after 14 frames of the slice (PlaneScene seed 1, 320x240, 512
features, 4 levels) and the next frame as the new keyframe.

Tolerances, as tests/test_torch_pipeline.py's ``test_keyframe_chain``:
integer fields (observations, validity) exactly equal; with local BA the
keyframe poses within 1e-3 and the points within 1e-2 of their distance to
the new keyframe, without it every float within 1e-3 (the triangulation's);
the final normals and depth bands within 1e-4 of the reference's stats
refresh of the port's own map.

Fuse with the stats refresh in triangulation (the System's setting with
fuse on) reads the normals and depth bands of the triangulated points, which
agree within the triangulation's 1e-3 only; on this state one association
(keyframe 0, feature 334) then falls on the other side of a fuse gate.  So
that case is held stage by stage: the reference's ``fuse_neighbors`` on the
port's own triangulated map gives the port's observations and validity
exactly, and end to end at most one of the K x N observations differs.
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

torch.set_num_threads(1)

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CAM = CameraModel.create(**ARGS)
TCAM = TCam.create(**ARGS)
SLICE = dict(enable_loop_closing=False, enable_relocalization=False, enable_kf_culling=False,
             enable_fuse=False, async_depth=0, shard_points=False)
STATS = ("mp_normal", "mp_min_dist", "mp_max_dist")
DEFAULTS = dict(do_cull_recent=True, stats_in_triangulate=False, do_fuse=False, do_local_ba=True)


T = lambda a: torch.from_numpy(np.array(a))


def nd(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def assert_map(m_t, m_j, atol, skip=()):
    got = convert.map_state_to_numpy(m_t)
    for k, ref in nd(m_j).items():
        if k in skip:
            continue
        if np.issubdtype(ref.dtype, np.floating):
            fin = np.isfinite(ref)
            np.testing.assert_array_equal(np.isfinite(got[k]), fin, err_msg=k)
            np.testing.assert_allclose(got[k][fin], ref[fin], atol=atol, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref, err_msg=k)


@pytest.fixture(scope="module")
def state():
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
    return slam, frame, step


def run_chains(state, toggles):
    """(reference chain, port chain, slot) on the state's map and frame."""
    slam, frame, step = state
    ref, slot, _ = jlm.keyframe_chain(slam.map, CAM, frame, step.R, step.t, step.obs, 14, 14 / 30.0,
                                      0.0, has_depth=False, do_kf_cull=False, **toggles)
    slot = int(slot)
    got, info = tlm.keyframe_chain(convert.map_state_from_numpy(nd(slam.map), device="cpu"), TCAM,
                                   convert.frame_from_numpy(nd(frame), device="cpu"), slot, T(step.R),
                                   T(step.t), T(step.obs), 14, 14 / 30.0, do_kf_cull=False, **toggles)
    assert not info.ok.any()
    return ref, got, slot


@pytest.mark.parametrize("flip", [dict(do_fuse=True), dict(do_cull_recent=False),
                                  dict(do_local_ba=False), dict(stats_in_triangulate=True)],
                         ids=["fuse", "no_recent_cull", "no_local_ba", "stats_in_triangulate"])
def test_keyframe_chain_toggles(state, flip):
    toggles = {**DEFAULTS, **flip}
    ref, got, slot = run_chains(state, toggles)
    assert_chain(got, ref, slot, toggles["do_local_ba"])


def test_keyframe_chain_fuse_with_stats(state):
    toggles = {**DEFAULTS, "do_fuse": True, "stats_in_triangulate": True}
    ref, got, slot = run_chains(state, toggles)
    differ = int((got.kf_obs != T(ref.kf_obs)).sum())
    assert differ <= 1, differ
    assert_chain(got.replace(kf_obs=T(ref.kf_obs)), ref, slot, True)
    # stage by stage: the reference's fuse on the port's own triangulated map
    slam, frame, step = state
    m = tlm.insert_keyframe_from_frame(convert.map_state_from_numpy(nd(slam.map), device="cpu"),
                                       convert.frame_from_numpy(nd(frame), device="cpu"), slot,
                                       T(step.R), T(step.t), T(step.obs), 14, 14 / 30.0)
    m = tlm.create_new_mappoints(tlm.cull_recent_mappoints(m), TCAM, slot, update_stats=True)
    fused = tlm.fuse_neighbors(m, TCAM, slot)
    m_j = jms.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_to_numpy(m).items()})
    fused_j = jlm.fuse_neighbors(m_j, CAM, jnp.asarray(slot), update_stats=False)
    np.testing.assert_array_equal(fused.kf_obs.numpy(), np.asarray(fused_j.kf_obs))
    np.testing.assert_array_equal(fused.mp_valid.numpy(), np.asarray(fused_j.mp_valid))


def assert_chain(got, ref, slot, local_ba):
    """The chain's tolerances (module docstring)."""
    if local_ba:
        assert_map(got, ref, 1e-3, skip=("mp_pos",) + STATS)
        pos, R, t = np.asarray(ref.mp_pos), np.asarray(ref.kf_R[slot]), np.asarray(ref.kf_t[slot])
        dist = np.linalg.norm(pos - (-R.T @ t), axis=1)
        assert np.all(np.linalg.norm(got.mp_pos.numpy() - pos, axis=1) <= 1e-2 * dist + 1e-6)
    else:
        assert_map(got, ref, 1e-3, skip=STATS)
    # the stats refresh, against the reference's refresh of the same map
    touched = tlm.window_touched_points(got, slot)
    m_j = jms.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_to_numpy(got).items()})
    ref_stats = jms.update_mappoint_stats_touched(m_j, jnp.asarray(touched.numpy()))
    assert_map(got, ref_stats, 1e-4, skip=("mp_desc",))
