"""Pipelined tracking (``async_depth=2``) in the port's System, against the
port's synchronous run and the JAX System's pipelined run on the slice
(PlaneScene seed 1, 320x240, 512 features, 4 levels, 30 frames), with the
ready test as it is (on the CPU a frame is ready once computed, so it
resolves at once) and held at "not ready" (every frame then resolves a full
async_depth frames late, as on a card busy with the frames after it).

Tolerances, as ``test_slice_matches_jax_system``: state OK, >= 70% of the
frames tracked, a record for every frame in order, and the Sim3-aligned ATE
<= max(1.5 x ATE_ref, ATE_ref + 0.01 m) and < 0.08 m, against each
reference run; keyframes within +-2 of the JAX System's pipelined run (the
lagged keyframe policy makes fewer than the synchronous one: 5 against 8
here).
"""

import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu.geometry import CameraModel
from orb_slam2_annotate_tpu.io import evaluation as jeval
from orb_slam2_annotate_tpu.io import synthetic as jsyn
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel as TCam
from orb_slam2_annotate_tpu_torch.pipeline import System as TSystem
from orb_slam2_annotate_tpu_torch.pipeline import mono_slice_config

torch.set_num_threads(1)

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
N_FRAMES = 30
DEPTH = 2
SIZES = dict(n_features=512, n_levels=4, max_kf=64, max_mp=8192, max_frames_between_kf=8,
             init_min_matches=60)


def ate(slam, poses):
    traj = dict(slam.frame_trajectory())
    ids = [k for k, T in traj.items() if T is not None]
    est = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids])
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids])
    return jeval.ate_rmse(est, gt, with_scale=True)[0], len(ids)


@pytest.fixture(scope="module")
def runs():
    """The slice through: the JAX System pipelined, the port synchronous,
    the port pipelined with the ready test as it is and held at "not
    ready"; with each pipelined port run, the in-flight count after every
    call and what each call returned."""
    scene = jsyn.PlaneScene(seed=1)
    poses = jsyn.orbit_trajectory(N_FRAMES, step=0.06)
    images = [scene.render(CameraModel.create(**ARGS), R, t, h=240, w=320)[0] for R, t in poses]
    ref = System(CameraModel.create(**ARGS), SlamConfig(enable_loop_closing=False, enable_fuse=False,
                                                        async_depth=DEPTH, shard_points=False,
                                                        **SIZES))
    for k, img in enumerate(images):
        ref.track_mono(img, k / 30.0)
    ref.flush()
    out = {"jax": (ref, None, None)}
    for name, depth, held in (("sync", 0, False), ("ready", DEPTH, False), ("held", DEPTH, True)):
        slam = TSystem(TCam.create(**ARGS), mono_slice_config(async_depth=depth, **SIZES),
                       device="cpu")
        if held:
            slam._ready = lambda e: False
        inflight, returned = [], []
        for k, img in enumerate(images):
            returned.append(slam.track_mono(img, k / 30.0))
            inflight.append(len(slam._inflight))
        slam.flush()
        out[name] = (slam, inflight, returned)
    return poses, out


@pytest.mark.parametrize("held", [False, True], ids=["ready", "held_not_ready"])
@pytest.mark.parametrize("against", ["sync", "jax"], ids=["port_sync", "jax_async"])
def test_pipelined_slice_matches(runs, held, against):
    poses, out = runs
    slam = out["held" if held else "ready"][0]
    ref = out[against][0]
    assert slam.state == "OK" and ref.state == "OK"
    assert [r.frame_id for r in slam.records] == list(range(N_FRAMES))
    assert not slam._inflight and slam._pending_cull is None
    ate_t, n_t = ate(slam, poses)
    ate_r, n_r = ate(ref, poses)
    assert n_t >= 0.7 * N_FRAMES, f"tracked {n_t}/{N_FRAMES} (reference {n_r})"
    if against == "jax":
        assert abs(slam.n_keyframes - ref.n_keyframes) <= 2
    assert ate_t <= max(1.5 * ate_r, ate_r + 0.01), (ate_t, ate_r)
    assert ate_t < 0.08


def test_pipeline_lag_and_return_value(runs):
    _, out = runs
    for name, lag in (("ready", 0), ("held", DEPTH)):
        slam, inflight, returned = out[name]
        # once tracking runs, the frames in flight after a call: none when
        # each is ready at once, async_depth when the ready test is held
        tracked = [n for n, T in zip(inflight, returned) if torch.is_tensor(T)]
        assert len(tracked) >= 0.7 * N_FRAMES
        assert max(tracked) == lag and tracked[-1] == lag, (name, tracked)
        T = returned[-1]
        assert torch.is_tensor(T) and T.shape == (4, 4) and T.device.type == "cpu"
        # the unresolved pose: the last step's, which the tracker continues from
        assert torch.equal(T[:3, :3], slam.R) and torch.equal(T[:3, 3], slam.t)
