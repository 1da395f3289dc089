"""Parity of the port's tracking step and keyframe chain with the JAX
package, on the JAX System's state after 14 frames of the slice (PlaneScene
seed 1, 320x240, 512 features, 4 levels) and the next frame.

Tolerances: integer fields (observations, validity, slots, counters) are
exactly equal; tracked poses agree within 1e-4; float fields within 1e-4
for stages that only rearrange data, 1e-3 after triangulation and for the
keyframe poses after local BA.  Map points after local BA agree within
1e-2 of their distance to the new keyframe: on this near-planar scene the
BA cost is flat along some point directions, and float-order noise
(9.5e-5 after one LM step) grows to ~4e-3 after ten, while the final cost
agrees to 1e-6 relative and the inlier sets are identical.  The chain's
final normals / depth bands are held to the reference's stats refresh of
the port's own map, within 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import synthetic
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System
from orb_slam2_annotate_tpu.pipeline import frame as jfr
from orb_slam2_annotate_tpu.pipeline import local_mapping as jlm
from orb_slam2_annotate_tpu.pipeline import policy as jpol
from orb_slam2_annotate_tpu.pipeline import tracking as jtk
from orb_slam2_annotate_tpu.worldmap import map_state as jms
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.pipeline import local_mapping as tlm
from orb_slam2_annotate_tpu_torch.pipeline import policy as tpol
from orb_slam2_annotate_tpu_torch.pipeline import tracking as ttk
from orb_slam2_annotate_tpu_torch.worldmap import map_state as tms

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CAM = CameraModel.create(**ARGS)
TCAM = TCam.create(**ARGS)
SLICE = dict(enable_loop_closing=False, enable_relocalization=False, enable_kf_culling=False,
             enable_fuse=False, async_depth=0, shard_points=False)
STATS = ("mp_normal", "mp_min_dist", "mp_max_dist")


def nd(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def T(a):
    return torch.from_numpy(np.array(a))


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


def assert_ba_map(m_t, m_j, slot, skip=()):
    """Local-BA outputs: everything at 1e-3 except points, which agree within
    1e-2 of their distance to the keyframe at `slot`."""
    assert_map(m_t, m_j, 1e-3, skip=("mp_pos",) + tuple(skip))
    ref = np.asarray(m_j.mp_pos)
    got = m_t.mp_pos.numpy()
    R, t = np.asarray(m_j.kf_R[slot]), np.asarray(m_j.kf_t[slot])
    dist = np.linalg.norm(ref - (-R.T @ t), axis=1)
    assert np.all(np.linalg.norm(got - ref, axis=1) <= 1e-2 * dist + 1e-6)


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
    img = scene.render(CAM, *poses[14], h=240, w=320)[0]
    frame = jfr.make_frame_mono(jnp.asarray(img), CAM, cfg.extractor)
    return slam, frame


def torch_state(slam, frame):
    m = convert.map_state_from_numpy(nd(slam.map), device="cpu")
    return (m, convert.frame_from_numpy(nd(frame), device="cpu"),
            convert.frame_from_numpy(nd(slam.last_frame), device="cpu"),
            T(slam.last_obs), T(slam.R), T(slam.t), T(slam.vel[0]), T(slam.vel[1]))


def test_convert_frame_and_camera(state):
    _, frame = state
    ref = nd(frame)
    f = convert.frame_from_numpy(ref, device="cpu")
    assert f.desc.dtype == torch.int32 and f.xy.dtype == torch.float32
    back = convert.frame_to_numpy(f)
    for k, v in ref.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert convert.camera_from_numpy(nd(CAM)) == TCAM


def test_track_frame(state):
    slam, frame = state
    ref = jtk.track_frame(CAM, slam.map, frame, slam.last_frame, slam.last_obs, slam.R, slam.t,
                          slam.vel[0], slam.vel[1], jnp.asarray(True),
                          jnp.asarray(slam.ref_kf, jnp.int32))
    m, f, lf, lo, R, t, vR, vt = torch_state(slam, frame)
    got = ttk.track_frame(TCAM, m, f, lf, lo, R, t, vR, vt, True, slam.ref_kf)
    stats = np.asarray(ref.stats)
    assert (got.n_pre, got.n_local, got.n_local_kf) == tuple(int(s) for s in stats)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_array_equal(got.obs.numpy(), np.asarray(ref.obs))
    np.testing.assert_array_equal(got.mp_visible.numpy(), np.asarray(ref.mp_visible))
    np.testing.assert_array_equal(got.mp_found.numpy(), np.asarray(ref.mp_found))
    poses = np.asarray(ref.poses)
    np.testing.assert_allclose(got.R_cr.numpy().reshape(9), poses[2, :9], atol=1e-4)
    np.testing.assert_allclose(got.vel_R.numpy().reshape(9), poses[1, :9], atol=1e-4)


@pytest.mark.parametrize("stage", ["reference_keyframe", "motion_model_wide"])
def test_tracking_stages(state, stage):
    slam, frame = state
    m, f, lf, lo, R, t, vR, vt = torch_state(slam, frame)
    if stage == "reference_keyframe":
        ref = jtk.track_reference_keyframe(CAM, slam.map, frame, slam.ref_kf, slam.R, slam.t)
        got = ttk.track_reference_keyframe(TCAM, m, f, slam.ref_kf, R, t)
    else:
        ref = jtk.track_with_motion_model(CAM, slam.map, frame, slam.last_frame, slam.last_obs,
                                          slam.R, slam.t, th=30.0)
        got = ttk.track_with_motion_model(TCAM, m, f, lf, lo, R, t, th=30.0)
    assert int(got[3]) == int(ref[3]) and int(ref[3]) > 20
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.fixture(scope="module")
def inserted(state):
    """The map after inserting the tracked next frame as a keyframe, in both
    packages, plus its slot."""
    slam, frame = state
    m, f, lf, lo, R, t, vR, vt = torch_state(slam, frame)
    step = jtk.track_frame(CAM, slam.map, frame, slam.last_frame, slam.last_obs, slam.R, slam.t,
                           slam.vel[0], slam.vel[1], jnp.asarray(True),
                           jnp.asarray(slam.ref_kf, jnp.int32))
    jm, slot = jlm.insert_keyframe_from_frame(slam.map, frame, step.R, step.t, step.obs, 14,
                                              14 / 30.0, update_stats=False)
    slot = int(slot)
    tm = tlm.insert_keyframe_from_frame(m, f, slot, T(step.R), T(step.t), T(step.obs), 14,
                                        14 / 30.0)
    assert_map(tm, jm, 0.0)
    return jm, tm, slot, (step, frame, f)


def test_cull_and_triangulate(inserted):
    jm, tm, slot, _ = inserted
    jc, tc = jlm.cull_recent_mappoints(jm), tlm.cull_recent_mappoints(tm)
    assert_map(tc, jc, 0.0)
    jn = jlm.create_new_mappoints(jc, CAM, jnp.asarray(slot), update_stats=False)
    tn = tlm.create_new_mappoints(tc, TCAM, slot)
    assert int(jnp.sum(jn.mp_valid)) > int(jnp.sum(jc.mp_valid))
    assert_map(tn, jn, 1e-3)


def test_local_ba_and_window(inserted):
    jm, tm, slot, _ = inserted
    np.testing.assert_array_equal(tlm.window_touched_points(tm, slot).numpy(),
                                  np.asarray(jlm.window_touched_points(jm, jnp.asarray(slot))))
    # the reference donates its map argument: hand it a copy
    ref = jlm.local_bundle_adjustment(jms.MapState(*(jnp.copy(a) for a in jm)), CAM,
                                      jnp.asarray(slot), update_stats=False).map
    got = tlm.local_bundle_adjustment(tm, TCAM, slot)
    assert_ba_map(got, ref, slot)
    moved = np.abs(np.asarray(ref.mp_pos) - np.asarray(jm.mp_pos)).max()
    assert moved > 1e-3  # the BA did move the map


def test_keyframe_chain(state):
    slam, frame = state
    step = jtk.track_frame(CAM, slam.map, frame, slam.last_frame, slam.last_obs, slam.R, slam.t,
                           slam.vel[0], slam.vel[1], jnp.asarray(True),
                           jnp.asarray(slam.ref_kf, jnp.int32))
    ref, slot, _ = jlm.keyframe_chain(slam.map, CAM, frame, step.R, step.t, step.obs, 14, 14 / 30.0,
                                      0.0, has_depth=False, do_cull_recent=True,
                                      stats_in_triangulate=False, do_fuse=False, do_local_ba=True,
                                      do_kf_cull=False)
    m = convert.map_state_from_numpy(nd(slam.map), device="cpu")
    f = convert.frame_from_numpy(nd(frame), device="cpu")
    got, info = tlm.keyframe_chain(m, TCAM, f, int(slot), T(step.R), T(step.t), T(step.obs), 14,
                                   14 / 30.0, do_kf_cull=False)
    assert not info.ok.any() and not info.R_rel.any()
    assert_ba_map(got, ref, int(slot), skip=STATS)
    # the stats refresh, against the reference's refresh of the same map
    touched = tlm.window_touched_points(got, int(slot))
    ref_stats = jms.update_mappoint_stats_touched(convert_back(got), jnp.asarray(touched.numpy()))
    assert_map(got, ref_stats, 1e-4, skip=("mp_desc",))


def convert_back(m_t):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in convert.map_state_to_numpy(m_t).items()})


def test_build_mono_init_map(state):
    slam, _ = state
    cfg = slam.cfg
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(9, step=0.06)
    f0, f1 = (jfr.make_frame_mono(jnp.asarray(scene.render(CAM, *poses[k], h=240, w=320)[0]), CAM,
                                  cfg.extractor) for k in (0, 8))
    from orb_slam2_annotate_tpu.ops import matching as jm
    from orb_slam2_annotate_tpu.solvers import initializer as jinit
    import jax

    res = jm.search_for_initialization(f0, f1, window=100.0)
    init = jinit.initialize_two_view(jax.random.PRNGKey(3), f0.xy, f1.xy[jnp.clip(res.idx, 0)],
                                     res.matched, 200, 1.0, CAM.K, min_parallax_deg=2.5)
    assert bool(init.success)
    empty = jms.empty_map(16, 2048, 512)
    ref, obs1 = jpol.build_mono_init_map(empty, CAM, f0, f1, init, res.idx, 0, 0.0, 8, 8 / 30.0)
    tinit = tpol.InitResult(**{k: T(getattr(init, k)) for k in
                               ("success", "used_homography", "R", "t", "points", "good", "n_good")})
    got, tobs1 = tpol.build_mono_init_map(tms.empty_map(16, 2048, 512), TCAM,
                                          convert.frame_from_numpy(nd(f0), device="cpu"),
                                          convert.frame_from_numpy(nd(f1), device="cpu"), tinit,
                                          T(res.idx), 0, 0.0, 8, 8 / 30.0)
    np.testing.assert_array_equal(tobs1.numpy(), np.asarray(obs1))
    assert_ba_map(got, ref, 1, skip=STATS)
    ref_stats = jms.update_mappoint_stats_touched(convert_back(got),
                                                  jnp.asarray(np.asarray(ref.mp_valid)))
    assert_map(got, ref_stats, 1e-4, skip=("mp_desc",))
