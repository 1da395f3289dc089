"""The port's free runner (pipeline/device_loop.py) against the JAX
FreeRunner, at the JAX tests' size: 320x240, 512 features, 4 levels,
max_kf = 32, max_mp = 8192, PlaneScene(seed=1) along
orbit_trajectory(24, step=0.05); loop closing off (tests/test_free_running.py).

Tolerances: mono and RGB-D runs (each package's own draws) -- tracked
frames within 2 of the reference's, keyframes within 2, and ATE (Sim3 for
mono, SE3 for RGB-D) within max(1.5 x, +0.01 m) of the reference's.  A JAX
FreeState carried into the port mid-run (convert.free_state_from_numpy)
and one more tracking frame through both steps (a frame the reference
tracks with no keyframe and no relocalization): mode, the frame's record
(reference slot, ok, mode, inliers), ref_kf and last_obs exactly equal; R,
t and the record's Tcr within 1e-4.  batch_detect_loops on the map and
database of the JAX mono run: cands, ok and cand_covis exactly equal on
the keyframe slots, ok on all.  Scan mode equal to per-frame mode: every
state tensor and the trajectory exactly equal.  The runner's branches
(auto-reset, growth, localization mode) are held to the JAX tests' bounds
(tests/test_free_parity.py).  Only the two JAX runs are compiled, once,
in one module fixture.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import evaluation, synthetic
from orb_slam2_annotate_tpu.pipeline import SlamConfig as JSlamConfig
from orb_slam2_annotate_tpu.pipeline import loop_closing as jlc
from orb_slam2_annotate_tpu.pipeline.device_loop import FreeRunner as JFreeRunner
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig
from orb_slam2_annotate_tpu_torch.pipeline import device_loop as dl
from orb_slam2_annotate_tpu_torch.pipeline import loop_closing as tlc

torch.set_num_threads(1)

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CAM, TCAM = CameraModel.create(**ARGS), TCam.create(**ARGS)
CAM_D, TCAM_D = CameraModel.create(**ARGS, bf=250.0 * 0.08), TCam.create(**ARGS, bf=250.0 * 0.08)
N_FRAMES = 24
CARRY = range(12, N_FRAMES - 1)     # frames whose incoming JAX state is kept


def _kw(**kw):
    base = dict(n_features=512, n_levels=4, max_kf=32, max_mp=8192, max_frames_between_kf=6,
                init_min_matches=60, enable_loop_closing=False)
    base.update(kw)
    return base


DEPTH_KW = dict(sensor="rgbd", th_depth=100.0)


def jax_state_numpy(st) -> dict:
    """A JAX FreeState as numpy, nested records as dicts."""
    return {k: ({f: np.asarray(x) for f, x in v._asdict().items()} if hasattr(v, "_asdict")
                else np.asarray(v)) for k, v in st._asdict().items()}


@pytest.fixture(scope="module")
def data():
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(40, step=0.05)
    frames = []
    for R, t in poses:
        img, dep = scene.render(CAM, R, t, h=240, w=320)
        frames.append((np.clip(img, 0, 255).astype(np.uint8), dep))
    return poses, frames


@pytest.fixture(scope="module")
def jax_runs(data):
    """The JAX FreeRunner on the mono and RGB-D frames; the mono run keeps
    its incoming state (as numpy) at the frames of CARRY and the one after."""
    _, frames = data
    out = {}
    for name, cam, kw in (("mono", CAM, {}), ("rgbd", CAM_D, DEPTH_KW)):
        r = JFreeRunner(cam, JSlamConfig(**_kw(**kw)), max_frames=N_FRAMES)
        states = {}
        for k in range(N_FRAMES):
            if name == "mono" and k in range(CARRY.start, CARRY.stop + 1):
                states[k] = jax_state_numpy(r.state)
            if name == "mono":
                r.track_mono(frames[k][0], k / 30.0)
            else:
                r.track_rgbd(frames[k][0], frames[k][1], k / 30.0)
        res = r.finish()
        out[name] = dict(result=res, states=states, vocab=r.vocab,
                         final=jax_state_numpy(r.state))
    return out


def port_run(frames, sensor="mono", keep_at=None, **kw):
    """The port's runner on the CPU, frame by frame; with keep_at, a copy of
    the runner as it stands before that frame is kept too."""
    cam = TCAM if sensor == "mono" else TCAM_D
    extra = {} if sensor == "mono" else DEPTH_KW
    r = dl.FreeRunner(cam, SlamConfig(**_kw(**extra, **kw.pop("cfg", {}))), device="cpu", **kw)
    kept = None
    for k, (img, dep) in enumerate(frames):
        if k == keep_at:
            kept = copy.deepcopy(r)
        if sensor == "mono":
            r.track_mono(img, k / 30.0)
        else:
            r.track_rgbd(img, dep, k / 30.0)
    return r, kept


@pytest.fixture(scope="module")
def port_mono(data):
    _, frames = data
    return port_run(frames[:N_FRAMES], keep_at=16, max_frames=N_FRAMES, auto_grow=False)


def ate(traj, poses, with_scale=True):
    ids = [k for k, T in traj if T is not None]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for k, T in traj if T is not None])
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids])
    return float(evaluation.ate_rmse(est.astype(np.float64), gt.astype(np.float64),
                                     with_scale=with_scale)[0]), len(ids)


def held_to_reference(got, ref, poses, with_scale):
    a_got, n_got = ate(got["trajectory"], poses, with_scale)
    a_ref, n_ref = ate(ref["trajectory"], poses, with_scale)
    assert abs(n_got - n_ref) <= 2, f"tracked {n_got} vs {n_ref}"
    assert abs(got["n_keyframes"] - ref["n_keyframes"]) <= 2, \
        f"keyframes {got['n_keyframes']} vs {ref['n_keyframes']}"
    assert a_got <= max(1.5 * a_ref, a_ref + 0.01), f"ATE {a_got:.4f} vs {a_ref:.4f}"
    return n_got


def test_free_runner_mono_matches_jax(data, jax_runs, port_mono):
    poses, _ = data
    out = port_mono[0].finish()
    n = held_to_reference(out, jax_runs["mono"]["result"], poses, True)
    assert n >= 10 and out["n_mappoints"] > 100 and out["n_resets"] == 0


def test_free_runner_rgbd_matches_jax(data, jax_runs):
    poses, frames = data
    r, _ = port_run(frames[:N_FRAMES], "rgbd", max_frames=N_FRAMES)
    out = r.finish()
    n = held_to_reference(out, jax_runs["rgbd"]["result"], poses, False)
    assert n >= 0.6 * N_FRAMES and out["n_keyframes"] >= 2


def test_jax_free_state_carried_into_the_port(data, jax_runs):
    _, frames = data
    run = jax_runs["mono"]
    fin = run["final"]
    # a frame the reference tracked from OK with no keyframe made on it
    kf_fids = set(fin["m"]["kf_frame_id"][fin["m"]["kf_valid"]].tolist())
    c = next(k for k in CARRY if run["states"][k]["mode"] == dl.MODE_OK
             and fin["ring_mode"][k] == dl.MODE_OK and k not in kf_fids
             and run["states"][k + 1]["m"]["n_kf"] == run["states"][k]["m"]["n_kf"])
    ref = run["states"][c + 1]
    runner = dl.FreeRunner(TCAM, SlamConfig(**_kw()), max_frames=N_FRAMES, device="cpu")
    st = convert.free_state_from_numpy(run["states"][c], device="cpu")
    step = dl.make_step(runner.cfg)
    got = convert.free_state_to_numpy(step(TCAM, runner.tab, runner.vocab, st,
                                           torch.from_numpy(frames[c][0]), c, c / 30.0, False))
    for k in ("mode", "ref_kf", "last_obs", "traj_ref", "traj_ok", "ring_mode", "ring_nlocal",
              "has_vel", "n_kf_skipped"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("R", "t", "vel_R", "vel_t", "traj"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["m"]["kf_valid"], ref["m"]["kf_valid"])
    assert got["traj_ok"][c] and got["mode"] == dl.MODE_OK


@pytest.mark.parametrize("gap_kf", [3, 0])
def test_batch_detect_loops_on_a_jax_run_map(jax_runs, gap_kf):
    run = jax_runs["mono"]
    m, bows = run["result"]["map"], run["final"]["bows"]
    ref = [np.asarray(a) for a in jlc.batch_detect_loops(run["vocab"], m, jax.numpy.asarray(bows),
                                                         gap_kf)]
    tv = convert.vocabulary_from_numpy({"words": np.asarray(run["vocab"].words),
                                        "idf": np.asarray(run["vocab"].idf)}, device="cpu")
    tm = convert.map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()},
                                      device="cpu")
    got = [a.numpy() for a in tlc.batch_detect_loops(tv, tm, torch.from_numpy(bows), gap_kf)]
    valid = np.asarray(m.kf_valid)
    assert valid.sum() >= 3
    np.testing.assert_array_equal(got[1], ref[1])
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a[valid], b[valid])


def test_scan_mode_equals_per_frame(data, port_mono):
    _, frames = data
    per_frame = port_mono[0]
    r = dl.FreeRunner(TCAM, SlamConfig(**_kw()), max_frames=N_FRAMES, auto_grow=False,
                      device="cpu")
    # two chunks of 10 through the scan, then a 4-frame tail frame by frame
    r.track_mono_sequence(np.stack([f[0] for f in frames[:N_FRAMES]]),
                          [k / 30.0 for k in range(N_FRAMES)], chunk=10)
    a, b = convert.free_state_to_numpy(r.state), convert.free_state_to_numpy(per_frame.state)
    for k in a:
        for f, x in (a[k].items() if isinstance(a[k], dict) else [(k, a[k])]):
            y = b[k][f] if isinstance(a[k], dict) else b[k]
            np.testing.assert_array_equal(x, y, err_msg=f"{k}.{f}")
    for (ka, Ta), (kb, Tb) in zip(r.finish()["trajectory"], per_frame.finish()["trajectory"]):
        assert ka == kb and (Ta is None) == (Tb is None)
        if Ta is not None:
            np.testing.assert_array_equal(Ta, Tb)


def test_auto_reset_after_an_early_loss(data):
    """Frames 14-19 blank: tracking is lost with a young map, the map is
    cleared, and the run initializes again (tests/test_free_parity.py)."""
    _, frames = data
    blank = np.zeros((240, 320), np.uint8)
    seq = [f[0] for f in frames[:14]] + [blank] * 6 + [f[0] for f in frames[20:40]]
    r = dl.FreeRunner(TCAM, SlamConfig(**_kw()), max_frames=len(seq), auto_grow=False,
                      device="cpu")
    reset_at = None
    for k, img in enumerate(seq):
        r.track_mono(img, k / 30.0)
        if reset_at is None and int(r.state.n_resets) > 0:
            reset_at = k
            m = r.state.m
            assert int(m.kf_valid.sum()) == 0 and int(m.mp_valid.sum()) == 0 and int(m.n_kf) == 0
            assert not r.state.traj_ok.any() and int(r.state.mode) == dl.MODE_FIRST
    out = r.finish()
    assert reset_at is not None and 14 <= reset_at < 20
    assert out["n_resets"] >= 1
    tracked_after = [k for k, T in out["trajectory"][20:] if T is not None]
    assert len(tracked_after) >= 8, "did not initialize again after the reset"
    assert out["n_keyframes"] >= 2


def test_growth_tiers_and_a_grown_run(data):
    poses, frames = data
    for max_kf, minf in ((8, 1), (32, 1), (8, 3)):
        jr = JFreeRunner(CAM, JSlamConfig(**_kw(max_kf=max_kf, min_frames_between_kf=minf)),
                         max_frames=8)
        tr = dl.FreeRunner(TCAM, SlamConfig(**_kw(max_kf=max_kf, min_frames_between_kf=minf)),
                           max_frames=8, device="cpu")
        for n in (1, 8, 24, 100, 1000):
            assert tr.grow_tiers_for(n) == jr.grow_tiers_for(n)
    r, _ = port_run(frames[:N_FRAMES], cfg=dict(max_kf=8), max_frames=8)
    out = r.finish()
    assert r.cfg.max_kf > 8 and r.state.m.K == r.cfg.max_kf and r.state.bows.shape[0] == r.cfg.max_kf
    assert r.max_frames >= N_FRAMES and len(r.growth_events) >= 2
    assert out["n_kf_skipped_full"] == 0
    assert ate(out["trajectory"], poses)[0] < 0.10


def test_localization_mode_makes_no_keyframe(data, port_mono):
    """From frame 16 on the map is frozen: tracking goes on, no keyframe
    is made."""
    _, frames = data
    r = port_mono[1]
    assert r.frame_id == 15
    r.activate_localization_mode()
    for k in range(16, N_FRAMES):
        r.track_mono(frames[k][0], k / 30.0)
    out = r.finish()
    assert len([k for k, T in out["trajectory"][16:] if T is not None]) >= 6
    m = out["map"]
    assert int(m.kf_frame_id[m.kf_valid].max()) < 16


def test_unported_entry_points_raise(tmp_path, data):
    # map save / load are ported (tests/test_torch_checkpoint.py), and so is
    # point sharding at a world of one, where it does nothing: the run is bit
    # for bit the unsharded one (above a world of one:
    # tests/test_torch_shard_points.py)
    r = dl.FreeRunner(TCAM, SlamConfig(**_kw()), max_frames=4, device="cpu")
    r.save_map(str(tmp_path / "map.npz"))
    r.load_map(str(tmp_path / "map.npz"))
    assert int(r.state.mode) == dl.MODE_LOST
    _, frames = data
    runs = []
    for shard in (True, False):
        r = dl.FreeRunner(TCAM, SlamConfig(**_kw(shard_points=shard)), max_frames=14,
                          auto_grow=False, device="cpu")
        for k in range(14):
            r.track_mono(frames[k][0], k / 30.0)
        runs.append(r.finish())
    for (k, T), (k0, T0) in zip(runs[0]["trajectory"], runs[1]["trajectory"]):
        assert k == k0 and ((T is None and T0 is None) or np.array_equal(T, T0))
    assert sum(T is not None for _, T in runs[0]["trajectory"]) >= 3
    for k, v in convert.map_state_to_numpy(runs[0]["map"]).items():
        np.testing.assert_array_equal(v, convert.map_state_to_numpy(runs[1]["map"])[k], err_msg=k)
