"""The port's RGB-D path against the JAX package: the RGB-D frame, the depth
map points, the depth-seeded bootstrap map, and the System on
tests/test_e2e_rgbd.py's cell (PlaneScene seed 2, 320x240, bf = 250 x 0.08,
512 features, 4 levels, th_depth 100).

Tolerances: the frame's raw xy, depth and valid are exactly equal, also for
keypoints at x.5 (the depth lookup rounds half to even) and on the border;
its undistorted xy and ur within 1e-4 px (the undistortion's float32 steps
round ~1 ulp apart from XLA's fused version: 3.1e-5 at x ~ 245);
the depth points' slots, mp_first_kf, kf_obs, mp_visible and mp_found are
exactly equal and their positions within 1e-5; the bootstrap map's stats
(descriptors exactly, normals and depth bands within 1e-5).  The Systems
both reach OK; the port tracks >= 80% of frames with a keyframe count
within +-2 of the reference's, an SE3-aligned ATE <= max(1.5 x ATE_jax,
ATE_jax + 0.01 m) and < 0.10 m, and an end-to-end displacement within 5%
of the truth.  RANSAC draws differ (torch.Generator vs jax.random), so the
runs are compared by outcome.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import evaluation as jeval
from orb_slam2_annotate_tpu.io import synthetic as jsyn
from orb_slam2_annotate_tpu.ops import extractor as jext
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System
from orb_slam2_annotate_tpu.pipeline import frame as jfr
from orb_slam2_annotate_tpu.pipeline import local_mapping as jlm
from orb_slam2_annotate_tpu.pipeline import policy as jpol
from orb_slam2_annotate_tpu.worldmap import map_state as jms
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.ops import extractor as text
from orb_slam2_annotate_tpu_torch.ops import orb as torb
from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig as TSlamConfig
from orb_slam2_annotate_tpu_torch.pipeline import System as TSystem
from orb_slam2_annotate_tpu_torch.pipeline import frame as tfr
from orb_slam2_annotate_tpu_torch.pipeline import local_mapping as tlm
from orb_slam2_annotate_tpu_torch.pipeline import policy as tpol

torch.set_num_threads(1)

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, bf=250.0 * 0.08, width=320, height=240)
CAM = CameraModel.create(**ARGS)
TCAM = TCam.create(**ARGS)
CFG_J = jext.ExtractorConfig(n_features=512, n_levels=4)
CFG_T = text.ExtractorConfig(n_features=512, n_levels=4)
MAX_DEPTH = 100.0 * 0.08          # th_depth baselines
N_FRAMES = 30
EXACT, CLOSE = ("xy_raw", "depth", "valid"), ("xy", "ur")


def nd(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


@pytest.fixture(scope="module")
def scene_frames():
    scene = jsyn.PlaneScene(seed=2)
    poses = jsyn.orbit_trajectory(N_FRAMES, step=0.06)
    return poses, [scene.render(CAM, R, t, h=240, w=320) for R, t in poses]


def test_make_frame_rgbd_agrees(scene_frames):
    _, frames = scene_frames
    img, dep = frames[3]
    ref = nd(jfr.make_frame_rgbd(jnp.asarray(img), jnp.asarray(dep), CAM, CFG_J))
    got = convert.frame_to_numpy(tfr.make_frame_rgbd(torch.from_numpy(img), torch.from_numpy(dep),
                                                     TCAM, torb.OrbTables(), CFG_T))
    assert (ref["valid"] & (ref["depth"] > 0)).sum() > 300
    for k in EXACT:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=0, err_msg=k)


def test_depth_lookup_rounds_half_to_even_and_clips(scene_frames, monkeypatch):
    """Given keypoints (x.5 and y.5 centres, the border, beyond it, and a
    pixel without depth), both frames read the same depth."""
    _, frames = scene_frames
    img, dep = frames[0]
    dep = dep.copy()
    dep[100, 40] = 0.0
    xy = np.array([[10.5, 20.0], [11.5, 20.5], [0.0, 0.0], [319.0, 239.0], [319.4, 239.6],
                   [-0.4, 5.5], [40.2, 99.5], [160.25, 120.75]], np.float32)
    n = xy.shape[0]
    feats = dict(xy=xy, response=np.ones(n, np.float32), octave=np.zeros(n, np.int32),
                 angle=np.zeros(n, np.float32), desc=np.zeros((n, 16), np.uint32),
                 valid=np.ones(n, bool))
    monkeypatch.setattr(jfr, "extract", lambda *a, **k: jext.Features(
        **{k_: jnp.asarray(v) for k_, v in feats.items()}))
    monkeypatch.setattr(tfr, "extract", lambda *a, **k: text.Features(
        **{k_: convert._to_torch(k_, v, "cpu") for k_, v in feats.items()}))
    ref = nd(jfr._make_frame_rgbd.__wrapped__(jnp.asarray(img), jnp.asarray(dep), CAM, None,
                                               CFG_J))
    got = convert.frame_to_numpy(tfr.make_frame_rgbd(torch.from_numpy(img), torch.from_numpy(dep),
                                                     TCAM, None, CFG_T))
    assert ref["depth"][6] == 0 and dep[99, 40] > 0   # y 99.5 reads row 100, which has none
    for k in EXACT:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def depth_maps(scene_frames):
    """The bootstrap map and a second keyframe's depth points, both packages."""
    _, frames = scene_frames
    f_j = [jfr.make_frame_rgbd(jnp.asarray(im), jnp.asarray(d), CAM, CFG_J) for im, d in frames[:2]]
    f_t = [convert.frame_from_numpy(nd(f)) for f in f_j]
    m0 = jms.empty_map(8, 2048, 512)
    m_j, slot = jpol.build_depth_init_map(m0, CAM, f_j[0], 0, 0.0, MAX_DEPTH)
    m_t = tpol.build_depth_init_map(convert.map_state_from_numpy(nd(m0)), TCAM, f_t[0], 0, 0, 0.0,
                                    MAX_DEPTH)
    # a second keyframe whose first 200 features observe the bootstrap's points
    obs = np.where(np.arange(512) < 200, np.asarray(m_j.kf_obs[0]), -1).astype(np.int32)
    R, t = np.eye(3, dtype=np.float32), np.array([0.01, 0.0, 0.02], np.float32)
    m1_j, slot1 = jlm.insert_keyframe_from_frame(m_j, f_j[1], jnp.asarray(R), jnp.asarray(t),
                                                 jnp.asarray(obs), 1, 0.1, update_stats=False)
    m1_j = jlm.create_depth_mappoints(m1_j, CAM, slot1, MAX_DEPTH, update_stats=False)
    m1_t = tlm.insert_keyframe_from_frame(m_t, f_t[1], int(slot1), torch.from_numpy(R),
                                          torch.from_numpy(t), torch.from_numpy(obs), 1, 0.1)
    m1_t = tlm.create_depth_mappoints(m1_t, TCAM, int(slot1), MAX_DEPTH)
    return (m_j, m_t, int(slot)), (m1_j, m1_t, int(slot1))


def assert_depth_points(m_t, m_j):
    got, ref = convert.map_state_to_numpy(m_t), nd(m_j)
    for k in ("mp_valid", "mp_first_kf", "kf_obs", "mp_visible", "mp_found", "n_kf"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["mp_pos"], ref["mp_pos"], atol=1e-5, rtol=0)


def test_build_depth_init_map_agrees(depth_maps):
    (m_j, m_t, slot), _ = depth_maps
    assert slot == 0 and int(m_t.mp_valid.sum()) > 300
    assert_depth_points(m_t, m_j)
    got, ref = convert.map_state_to_numpy(m_t), nd(m_j)
    np.testing.assert_array_equal(got["mp_desc"], ref["mp_desc"])
    for k in ("mp_normal", "mp_min_dist", "mp_max_dist"):
        v = ref["mp_valid"]
        np.testing.assert_allclose(got[k][v], ref[k][v], atol=1e-5, rtol=1e-5, err_msg=k)


def test_create_depth_mappoints_agrees(depth_maps):
    (m_j, _, _), (m1_j, m1_t, slot1) = depth_maps
    new = int(m1_j.mp_valid.sum()) - int(m_j.mp_valid.sum())
    assert slot1 == 1 and new > 100        # points only where the keyframe has none
    assert_depth_points(m1_t, m1_j)


def test_system_matches_jax_system(scene_frames):
    poses, frames = scene_frames
    sizes = dict(sensor="rgbd", n_features=512, n_levels=4, max_kf=64, max_mp=8192,
                 max_frames_between_kf=8, th_depth=100.0)
    ref = System(CAM, SlamConfig(**sizes))
    port = TSystem(TCAM, TSlamConfig(**sizes), device="cpu")
    for k, (img, dep) in enumerate(frames):
        ref.track_rgbd(img, dep, k / 30.0)
        port.track_rgbd(img, dep, k / 30.0)
    assert ref.state == "OK" and port.state == "OK"

    def outcome(slam):
        traj = dict(slam.frame_trajectory())
        ids = [k for k, T in traj.items() if T is not None]
        est = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids]).astype(np.float64)
        gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids]).astype(np.float64)
        scale = np.linalg.norm(est[-1] - est[0]) / np.linalg.norm(gt[-1] - gt[0])
        return jeval.ate_rmse(est, gt, with_scale=False)[0], len(ids), scale

    ate_j, n_j, _ = outcome(ref)
    ate_t, n_t, scale_t = outcome(port)
    assert n_t >= 0.8 * N_FRAMES, f"port tracked {n_t}/{N_FRAMES} (reference {n_j})"
    assert abs(port.n_keyframes - ref.n_keyframes) <= 2, (port.n_keyframes, ref.n_keyframes)
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.01) and ate_t < 0.10, (ate_t, ate_j)
    assert abs(scale_t - 1.0) < 0.05, scale_t
