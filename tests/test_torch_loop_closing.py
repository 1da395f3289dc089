"""The port's loop closing (pipeline/loop_closing.py, the SearchAndFuse of
pipeline/local_mapping.py, map_state.update_mappoint_geometry) against the
JAX package, on the constructed-drift map of tests/test_loop_components.py
(K = 16 slots, N = 128 features; keyframe 11 revisits keyframe 0 with
drift) and the drift-gate chain of the same file.

Tolerances: stage by stage on the same input map -- drift_accumulators
within 1e-5; apply_loop_correction's poses and points within 1e-5;
sim3_guided_match, loop_projection_count, fuse_points_into (kf_obs and
mp_valid) and update_mappoint_geometry's validity exactly equal, its
normals and depth bands within 1e-5; fold_gba_device within 1e-5.  The
whole LoopCloser.on_keyframe, then maybe_fold_gba(force=True), closes the
loop in both packages (its Sim3 RANSAC draws from a torch.Generator, so it
is compared by outcome), with the scale free and, on the same map with
depth on every feature (an RGB-D sensor's), with the scale fixed: equal
loop edges, corrected keyframe 11 within 0.08 m of the truth and within
1e-3 of the reference's.  _drift_plausible gives the
reference's verdicts on the plausible, teleport and scale cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.ops.orb import DESC_WORDS as DW
from orb_slam2_annotate_tpu.pipeline import local_mapping as jlm
from orb_slam2_annotate_tpu.pipeline import loop_closing as jlc
from orb_slam2_annotate_tpu.worldmap import map_state as jms
from orb_slam2_annotate_tpu.worldmap import vocabulary as jvoc
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.pipeline import System as TSystem
from orb_slam2_annotate_tpu_torch.pipeline import local_mapping as tlm
from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_annotate_tpu_torch.pipeline import mono_slice_config
from orb_slam2_annotate_tpu_torch.worldmap import map_state as tms

torch.set_num_threads(1)

ARGS = dict(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240)
CAM = CameraModel.create(**ARGS)
TCAM = TCam.create(**ARGS)
K, P, N = 16, 2048, 128
SLOT, CAND = 11, 0


def T(a):
    return torch.from_numpy(np.array(a))


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=0, atol=tol)


def port_map(m) -> tms.MapState:
    return convert.map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()},
                                        device="cpu")


BF = 400.0 * 0.08   # the depth map's baseline x fx (an RGB-D sensor's virtual right camera)


def drift_map(depth: bool = False):
    """Keyframes 0-10 sweep away and back over their own random scenes;
    keyframe 11 truly sits at keyframe 0's pose and sees its scene, but is
    estimated with a drift of (0.25, 0.1, -0.15) and holds its own copies of
    the points (no covisibility link to keyframe 0).  With `depth`, every
    feature has its camera depth and virtual right coordinate u - BF / z."""
    rng = np.random.RandomState(7)
    m = jms.empty_map(K, P, N)
    X0 = rng.uniform([-2, -2, 4], [2, 2, 8], (N, 3)).astype(np.float32)
    desc0 = rng.randint(0, 2**32, (N, DW), np.uint64).astype(np.uint32)

    def add_kf(m, slot, t, Xw, desc):
        Xc = Xw + t
        uv = np.stack([400 * Xc[:, 0] / Xc[:, 2] + 160, 400 * Xc[:, 1] / Xc[:, 2] + 120],
                      1).astype(np.float32)
        base = slot * N
        z = Xc[:, 2].astype(np.float32)
        ur = (uv[:, 0] - BF / z).astype(np.float32) if depth else np.full((N,), -1.0, np.float32)
        dz = z if depth else np.zeros((N,), np.float32)
        m = jms.insert_keyframe(
            m, jnp.asarray(slot), jnp.eye(3), jnp.asarray(t), slot, float(slot), jnp.asarray(uv),
            jnp.asarray(ur), jnp.asarray(dz), jnp.zeros((N,), jnp.int32), jnp.zeros((N,)),
            jnp.asarray(desc), jnp.ones((N,), bool), jnp.arange(base, base + N, dtype=jnp.int32))
        return m._replace(mp_pos=m.mp_pos.at[base:base + N].set(jnp.asarray(Xw)),
                          mp_valid=m.mp_valid.at[base:base + N].set(True),
                          mp_desc=m.mp_desc.at[base:base + N].set(jnp.asarray(desc)))

    m = add_kf(m, 0, np.zeros(3, np.float32), X0, desc0)
    for k in range(1, 11):
        Xk = rng.uniform([-2, -2, 4], [2, 2, 8], (N, 3)).astype(np.float32)
        dk = rng.randint(0, 2**32, (N, DW), np.uint64).astype(np.uint32)
        m = add_kf(m, k, np.array([-0.3 * min(k, 11 - k), 0, 0], np.float32), Xk, dk)
    drift = np.array([0.25, 0.1, -0.15], np.float32)
    m = add_kf(m, SLOT, drift, X0 - drift, desc0)
    return jms.update_mappoint_stats(m)


@pytest.fixture(scope="module")
def drift():
    return drift_map()


def loop_closers(m, fix_scale: bool = False):
    """Both packages' LoopClosers with keyframes 0-10 in the database, the
    port's given the reference's state through convert.py."""
    cfg = dict(consistency_th=1, gap_kf=3, fix_scale=fix_scale)
    lc = jlc.LoopCloser(CAM, K, jlc.LoopCloserConfig(**cfg))
    for k in range(SLOT):
        lc.db = lc.db.add(k, jvoc.bow_vector(lc.vocab, m.kf_desc[k], m.kf_feat_valid[k]))
    tl = tlc.LoopCloser(TCAM, K, tlc.LoopCloserConfig(**cfg), device="cpu")
    convert.loop_closer_state_from_numpy(tl, convert.loop_closer_state_to_numpy(lc))
    return lc, tl


@pytest.mark.parametrize("fix_scale", [False, True])
def test_loop_closer_closes_the_constructed_drift_in_both(drift, fix_scale):
    if fix_scale:
        drift = drift_map(depth=True)
    lc, tl = loop_closers(drift, fix_scale)
    state = convert.loop_closer_state_to_numpy(tl)
    np.testing.assert_array_equal(state["bows"], np.asarray(lc.db.bows))
    m2, closed = lc.on_keyframe(drift, SLOT)
    m2 = lc.maybe_fold_gba(m2, force=True)
    tm2, tclosed = tl.on_keyframe(port_map(drift), SLOT)
    tm2 = tl.maybe_fold_gba(tm2, force=True)
    assert closed and tclosed
    assert tl.n_loops_closed == lc.n_loops_closed == 1 and tl.loop_edges == lc.loop_edges
    assert tl.n_gba_dispatched == 1 and tl.n_gba_folded == 1
    t_ref, t_port = np.asarray(m2.kf_t[SLOT]), tm2.kf_t[SLOT].numpy()
    assert np.linalg.norm(t_port) < 0.08
    close(t_ref, t_port, 1e-3)


@pytest.fixture(scope="module")
def corrected(drift):
    """The reference's correction of the drift map, stage by stage: the
    corrective Sim3 is the truth (identity from keyframe 0's camera to
    keyframe 11's)."""
    s12, R12, t12 = jnp.ones(()), jnp.eye(3), jnp.zeros(3)
    s_c, R_c, t_c = jlc.lie.sim3_compose(s12, R12, t12, jnp.ones(()), drift.kf_R[CAND],
                                         drift.kf_t[CAND])
    z = jnp.zeros(16, jnp.int32)
    prob = jlc.build_essential_graph(drift, jnp.asarray(SLOT), jnp.asarray(CAND), s_c, R_c, t_c,
                                     s12, R12, t12, z, z, jnp.zeros(16, bool))
    sol = jlc.optimize_pose_graph(prob, 15)
    return sol, jlc.apply_loop_correction(drift, *sol[:3])


def test_drift_accumulators_agree(drift):
    for a, b in zip(jlc.drift_accumulators(drift, CAND, SLOT),
                    tlc.drift_accumulators(port_map(drift), CAND, SLOT)):
        close(a, b.numpy(), 1e-5)


def test_apply_loop_correction_agrees(drift, corrected):
    sol, ref = corrected
    got = tlc.apply_loop_correction(port_map(drift), *(T(np.asarray(v)) for v in sol[:3]))
    for name in ("kf_R", "kf_t", "mp_pos"):
        close(getattr(ref, name), getattr(got, name).numpy(), 1e-5)


@pytest.mark.parametrize("radius_scale", [3.0, 1.5])
def test_sim3_guided_match_agrees(drift, radius_scale):
    # the true Sim3 (identity: keyframe 11's camera sees its points where
    # keyframe 0's sees the originals) and one off by the drift
    for t12 in (np.zeros(3, np.float32), np.array([0.25, 0.1, -0.15], np.float32)):
        ref = jlc.sim3_guided_match(CAM, drift, jnp.asarray(SLOT), jnp.asarray(CAND), jnp.ones(()),
                                    jnp.eye(3), jnp.asarray(t12), radius_scale=radius_scale)
        got = tlc.sim3_guided_match(TCAM, port_map(drift), SLOT, CAND, torch.ones(()),
                                    torch.eye(3), T(t12), radius_scale=radius_scale)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        if not t12.any():
            assert (got >= 0).sum() > 100


def test_loop_projection_count_agrees(drift):
    for t12 in (np.zeros(3, np.float32), np.array([0.02, -0.01, 0.03], np.float32)):
        n_ref, fp_ref = jlc.loop_projection_count(CAM, drift, jnp.asarray(SLOT), jnp.asarray(CAND),
                                                  jnp.ones(()), jnp.eye(3), jnp.asarray(t12))
        n_got, fp_got = tlc.loop_projection_count(TCAM, port_map(drift), SLOT, CAND,
                                                  torch.ones(()), torch.eye(3), T(t12))
        assert int(n_got) == int(n_ref) > 25
        np.testing.assert_array_equal(fp_got.numpy(), np.asarray(fp_ref))


def test_fuse_points_into_agrees(corrected):
    _, m = corrected
    W = np.asarray(jms.covisibility(m))
    targets = np.array([SLOT, 10, 9, 1], np.int32)
    tgt_ok = np.array([True, True, W[SLOT, 9] > 0, False])
    loop_pts = np.asarray(jnp.any(jms.observation_matrix(m)
                                  & jnp.zeros(K, bool).at[CAND].set(True)[:, None], axis=0))
    ref = jlm.fuse_points_into(m, CAM, jnp.asarray(targets), jnp.asarray(tgt_ok),
                               jnp.asarray(loop_pts), update_stats=False)
    got = tlm.fuse_points_into(port_map(m), TCAM, T(targets).long(), T(tgt_ok), T(loop_pts))
    np.testing.assert_array_equal(got.kf_obs.numpy(), np.asarray(ref.kf_obs))
    np.testing.assert_array_equal(got.mp_valid.numpy(), np.asarray(ref.mp_valid))
    # the seam's duplicates were merged
    assert int(got.mp_valid.sum()) < int(port_map(m).mp_valid.sum())


def test_update_mappoint_geometry_agrees(corrected):
    _, m = corrected
    ref = jms.update_mappoint_geometry(m)
    got = tms.update_mappoint_geometry(port_map(m))
    np.testing.assert_array_equal(got.mp_valid.numpy(), np.asarray(ref.mp_valid))
    ok = np.asarray(ref.mp_valid)
    for name in ("mp_normal", "mp_min_dist", "mp_max_dist"):
        close(np.asarray(getattr(ref, name))[ok], getattr(got, name).numpy()[ok], 1e-5)
    np.testing.assert_array_equal(got.mp_desc.numpy().view(np.uint32), np.asarray(ref.mp_desc))


def test_fold_gba_device_agrees(drift):
    """Keyframes 9-11 and the points above 1200 came after the dispatch;
    the BA moved the solved ones."""
    rng = np.random.RandomState(3)
    snap_kf = np.asarray(drift.kf_valid) & (np.arange(K) < 9)
    snap_mp = np.asarray(drift.mp_valid) & (np.arange(P) < 1200)
    old_R, old_t = np.asarray(drift.kf_R), np.asarray(drift.kf_t)
    gba_R = np.asarray(jnp.einsum("kij,kjl->kil", jlc.lie.so3_exp(jnp.asarray(
        rng.randn(K, 3).astype(np.float32) * 0.01)), drift.kf_R))
    gba_t = (old_t + rng.randn(K, 3) * 0.02).astype(np.float32)
    gba_X = (np.asarray(drift.mp_pos) + rng.randn(P, 3) * 0.01).astype(np.float32)
    args = (gba_R, gba_t, gba_X, snap_kf, snap_mp, old_R, old_t)
    ref = jlc.fold_gba_device(drift, *(jnp.asarray(a) for a in args))
    got = tlc.fold_gba_device(port_map(drift), *(T(a) for a in args))
    for name in ("kf_R", "kf_t", "mp_pos", "mp_normal"):
        close(getattr(ref, name), getattr(got, name).numpy(), 1e-5)
    np.testing.assert_array_equal(got.mp_valid.numpy(), np.asarray(ref.mp_valid))


def chain_map():
    """Six keyframes 0.3 m apart with 10 degrees of yaw each (the drift-gate
    chain of tests/test_loop_components.py)."""
    Kc, Pc, Nc = 8, 256, 16
    m = jms.empty_map(Kc, Pc, Nc)
    for k in range(6):
        yaw = np.radians(10.0 * k)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
                     np.float32)
        t = (-R @ np.array([0.3 * k, 0, 0])).astype(np.float32)
        m = jms.insert_keyframe(
            m, jnp.asarray(k), jnp.asarray(R), jnp.asarray(t), k, float(k), jnp.zeros((Nc, 2)),
            jnp.full((Nc,), -1.0), jnp.zeros((Nc,)), jnp.zeros((Nc,), jnp.int32), jnp.zeros((Nc,)),
            jnp.zeros((Nc, DW), jnp.uint32), jnp.ones((Nc,), bool), jnp.full((Nc,), -1, jnp.int32))
    return m


def test_drift_plausible_gives_the_reference_verdicts():
    m = chain_map()
    lc = jlc.LoopCloser(CAM, 8, jlc.LoopCloserConfig())
    tl = tlc.LoopCloser(TCAM, 8, tlc.LoopCloserConfig(), device="cpu")
    tm = port_map(m)
    R5, t5 = np.asarray(m.kf_R[5]), np.asarray(m.kf_t[5])
    eps = np.radians(2.0)
    R_eps = np.array([[np.cos(eps), 0, np.sin(eps)], [0, 1, 0], [-np.sin(eps), 0, np.cos(eps)]],
                     np.float32)
    R_big = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    cases = [(1.02, R_eps @ R5, t5 + [0.03, 0.0, 0.02], True),   # plausible residual drift
             (1.0, R_big @ R5, t5, False),                      # teleport
             (3.0, R_eps @ R5, t5, False)]                      # scale explosion
    for s, R, t, want in cases:
        ref = lc._drift_plausible(m, 5, 0, s, jnp.asarray(R), jnp.asarray(t))
        got = tl._drift_plausible(tm, 5, 0, s, T(R).float(), T(t).float())
        assert bool(ref) == got == want


def test_system_with_loop_closing_builds_the_loop_closer():
    """Loop closing on and relocalization off: the LoopCloser exists and
    every keyframe after the bootstrap writes its BoW row."""
    from orb_slam2_annotate_tpu_torch.io import synthetic as tsyn

    cam = TCam.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    cfg = mono_slice_config(n_features=512, n_levels=4, max_kf=32, max_mp=4096,
                            max_frames_between_kf=4, init_min_matches=60,
                            enable_loop_closing=True, enable_relocalization=False)
    slam = TSystem(cam, cfg, device="cpu")
    assert slam.loop_closer is not None
    scene = tsyn.PlaneScene(seed=1)
    poses = tsyn.orbit_trajectory(20, step=0.06)
    for k in range(20):
        slam.track_mono(scene.render(cam, *poses[k], h=240, w=320)[0], k / 30.0)
    assert slam.state == "OK" and slam.n_keyframes >= 4
    rows = slam.loop_closer.db.bows.abs().sum(1) > 0
    valid = torch.from_numpy(slam._kf_valid_host)
    assert torch.equal(rows, valid & (torch.arange(32) >= 2))
