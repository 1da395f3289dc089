"""The port's map checkpoint (io/checkpoint.py) and the map I/O of its
System and FreeRunner, against the JAX package's format.

Tolerances: a map file written by either package loads in the other with
every field equal bit for bit and of the same dtype (descriptors with the
top bit set included: uint32 in the file, int32 in the port).  The port's
System.save_map -> load_map round trip at tests/test_checkpoint.py's size
(RGB-D, 320x240, 512 features, 12 frames): every field bit for bit, the
keyframe database rows the live System wrote within 1e-6, the state LOST,
and a frame from inside the map relocalized with its camera centre within
0.30 m of the truth (tests/test_checkpoint.py's bound).  FreeRunner.load_map
grows its tiers to fit a larger file and its map to its tiers for a smaller
one, every loaded field bit for bit.  warmup leaves the System's state as
it was (map fields bit for bit).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.io import checkpoint as jck
from orb_slam2_annotate_tpu.worldmap import map_state as jms
from orb_slam2_annotate_tpu_torch import convert
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
from orb_slam2_annotate_tpu_torch.io import checkpoint as tck
from orb_slam2_annotate_tpu_torch.io import synthetic
from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig, System
from orb_slam2_annotate_tpu_torch.pipeline import device_loop as dl
from orb_slam2_annotate_tpu_torch.worldmap import map_state as tms

torch.set_num_threads(1)

CAM = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, bf=250.0 * 0.08, width=320,
                         height=240)
CFG = SlamConfig(sensor="rgbd", n_features=512, n_levels=4, max_kf=32, max_mp=4096,
                 max_frames_between_kf=4, th_depth=100.0)


def random_map(K=8, P=64, N=32, seed=0) -> dict:
    """A JAX-layout map (numpy, uint32 descriptors) with every field drawn
    from a seed, half the descriptor words with the top bit set."""
    rng = np.random.RandomState(seed)
    m = {k: np.asarray(v) for k, v in jms.empty_map(K, P, N)._asdict().items()}
    out = {}
    for k, v in m.items():
        if v.dtype == np.bool_:
            out[k] = rng.rand(*v.shape) < 0.5
        elif v.dtype == np.uint32:
            out[k] = rng.randint(0, 2**32, size=v.shape, dtype=np.uint64).astype(np.uint32)
            out[k].reshape(-1)[::2] |= np.uint32(1 << 31)
        elif v.dtype == np.int32:
            out[k] = rng.randint(-1, 1000, size=v.shape).astype(np.int32)
        else:
            out[k] = rng.randn(*v.shape).astype(v.dtype)
    return out


def assert_maps_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_map_file_loads_in_the_other_package(tmp_path, writer):
    ref = random_map()
    assert (ref["kf_desc"] >> 31).any() and (ref["mp_desc"] >> 31).any()
    path = str(tmp_path / "map.npz")
    if writer == "jax":
        jck.save_map(path, jms.MapState(**{k: jnp.asarray(v) for k, v in ref.items()}),
                     extra={"note": writer})
        m, extra = tck.load_map(path, "cpu")
        got = convert.map_state_to_numpy(m)
        assert m.kf_desc.dtype == torch.int32 and m.n_kf.shape == ()
    else:
        tck.save_map(path, convert.map_state_from_numpy(ref, device="cpu"), extra={"note": writer})
        m, extra = jck.load_map(path)
        got = {k: np.asarray(v) for k, v in m._asdict().items()}
    assert extra == {"note": writer}
    assert_maps_equal(got, ref)


def test_load_rejects_another_format(tmp_path):
    path = str(tmp_path / "map.npz")
    tck.save_map(path, tms.empty_map(4, 16, 8))
    z = dict(np.load(path))
    z["header"] = np.frombuffer(b'{"format_version": 2}', np.uint8)
    np.savez(path, **z)
    with pytest.raises(ValueError, match="unsupported map format"):
        tck.load_map(path, "cpu")


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """The port's System over tests/test_checkpoint.py's 12 RGB-D frames,
    warmed up first; its map saved."""
    scene = synthetic.PlaneScene(seed=5)
    poses = synthetic.orbit_trajectory(12, step=0.06)
    slam = System(CAM, CFG, device="cpu")
    before = {f.name: getattr(slam.map, f.name).clone() for f in dataclasses.fields(tms.MapState)}
    slam.warmup()
    warm = dict(state=slam.state, frame_id=slam.frame_id, records=len(slam.records),
                map_same=all(torch.equal(before[k], getattr(slam.map, k)) for k in before),
                db_zero=not slam.loop_closer.db.bows.any())
    for k, (R, t) in enumerate(poses):
        img, dep = scene.render(CAM, R, t, h=240, w=320)
        slam.track_rgbd(img, dep, k / 30.0)
    path = str(tmp_path_factory.mktemp("ckpt") / "map.npz")
    slam.save_map(path)
    return slam, path, scene, poses, warm


def test_warmup_leaves_the_state(session):
    warm = session[4]
    assert warm == dict(state="NO_IMAGES", frame_id=-1, records=0, map_same=True, db_zero=True)


def test_system_save_load_and_relocalize(session):
    slam, path, scene, poses, _ = session
    assert slam.n_keyframes >= 2
    slam2 = System(CAM, CFG, device="cpu")
    slam2.load_map(path)
    assert_maps_equal(convert.map_state_to_numpy(slam2.map), convert.map_state_to_numpy(slam.map))
    assert slam2.state == "LOST" and slam2.vel is None and slam2.ref_kf == slam.ref_kf
    assert slam2.n_keyframes == slam.n_keyframes
    np.testing.assert_array_equal(slam2._kf_valid_host, slam.map.kf_valid.numpy())
    # the rows the live System wrote (the bootstrap keyframe has none, as in
    # the reference) equal the rebuilt ones; unused slots are zero
    old, new = slam.loop_closer.db.bows, slam2.loop_closer.db.bows
    written = old.abs().sum(1) > 0
    assert written.sum() >= 1
    torch.testing.assert_close(new[written], old[written], rtol=0, atol=1e-6)
    assert not new[~slam.map.kf_valid].any()
    img, dep = scene.render(CAM, *poses[6], h=240, w=320)
    T = slam2.track_rgbd(img, dep, 99.0)
    assert T is not None, "relocalization into the loaded map failed"
    c_est = -T[:3, :3].T @ T[:3, 3]
    c_gt = -poses[6][0].T @ poses[6][1]
    assert np.linalg.norm(c_est - c_gt) < 0.30, (c_est, c_gt)


def test_change_calibration_leaves_the_loop_closer():
    slam = System(CAM, CFG, device="cpu")
    cam2 = dataclasses.replace(CAM, fx=260.0)
    slam.change_calibration(cam2)
    assert slam.cam is cam2 and slam.loop_closer.cam is CAM


def _runner(max_kf, max_mp, n_features=32):
    cfg = SlamConfig(n_features=n_features, n_levels=2, max_kf=max_kf, max_mp=max_mp)
    return dl.FreeRunner(CAM, cfg, max_frames=8, device="cpu")


@pytest.mark.parametrize("K,P", [(16, 256), (4, 64)])
def test_free_runner_load_map_fits_the_tiers(tmp_path, K, P):
    """A larger file grows the runner's tiers; a smaller map grows to them."""
    ref = random_map(K=K, P=P, N=32, seed=1)
    path = str(tmp_path / "map.npz")
    jck.save_map(path, jms.MapState(**{k: jnp.asarray(v) for k, v in ref.items()}))
    runner = _runner(8, 128)
    runner.load_map(path)
    st = runner.state
    assert (runner.cfg.max_kf, runner.cfg.max_mp) == (max(K, 8), max(P, 128))
    assert st.m.K == runner.cfg.max_kf and st.m.P == runner.cfg.max_mp
    assert st.bows.shape == (st.m.K, runner.vocab.n_words) and st.streaks.shape == (st.m.K,)
    assert int(st.mode) == dl.MODE_LOST
    assert runner._mp_ratio >= -(-runner.cfg.max_mp // runner.cfg.max_kf)
    got = convert.map_state_to_numpy(st.m)
    for k, v in ref.items():
        sl = tuple(slice(0, n) for n in v.shape)
        np.testing.assert_array_equal(got[k][sl], v, err_msg=k)
    # the rows of invalid keyframes are zero
    assert not st.bows[~st.m.kf_valid].any()


def test_free_runner_save_load_round_trip(tmp_path):
    ref = random_map(K=8, P=128, N=32, seed=2)
    runner = _runner(8, 128)
    runner.state = runner.state.replace(m=convert.map_state_from_numpy(ref, device="cpu"))
    path = str(tmp_path / "map.npz")
    runner.save_map(path)
    runner2 = _runner(8, 128)
    runner2.load_map(path)
    assert_maps_equal(convert.map_state_to_numpy(runner2.state.m), ref)
    with pytest.raises(ValueError, match="features"):
        _runner(8, 128, n_features=64).load_map(path)
    runner2.frame_id = 0
    with pytest.raises(RuntimeError, match="precede tracking"):
        runner2.load_map(path)
