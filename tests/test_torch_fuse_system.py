"""The port's System with fuse on (``enable_fuse=True``, so the stats
refresh in triangulation too) against the JAX System with the same setting
on the slice (PlaneScene seed 1, 320x240, 512 features, 4 levels, 30
frames; loop closing off, relocalization and keyframe culling on).

Tolerances, as ``test_slice_matches_jax_system``: both reach OK; the port
tracks >= 70% of the frames, its keyframe count is within +-2 of the
reference's, and its Sim3-aligned ATE is <= max(1.5 x ATE_jax, ATE_jax +
0.01 m) and < 0.08 m.  The reference measured fuse worse than no fuse on
such planar scenes (its ``SlamConfig``), so the port is held to the
reference's run, not to an improvement.
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
from orb_slam2_annotate_tpu_torch.pipeline import local_mapping as tlm
from orb_slam2_annotate_tpu_torch.pipeline import mono_slice_config

torch.set_num_threads(1)

ARGS = dict(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
N_FRAMES = 30
SIZES = dict(n_features=512, n_levels=4, max_kf=64, max_mp=8192, max_frames_between_kf=8,
             init_min_matches=60)


def ate(slam, poses):
    traj = dict(slam.frame_trajectory())
    ids = [k for k, T in traj.items() if T is not None]
    est = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids])
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids])
    return jeval.ate_rmse(est, gt, with_scale=True)[0], len(ids)


@pytest.fixture(scope="module")
def fuse_runs(monkeypatch_module):
    scene = jsyn.PlaneScene(seed=1)
    poses = jsyn.orbit_trajectory(N_FRAMES, step=0.06)
    images = [scene.render(CameraModel.create(**ARGS), R, t, h=240, w=320)[0] for R, t in poses]
    ref = System(CameraModel.create(**ARGS), SlamConfig(enable_loop_closing=False, enable_fuse=True,
                                                        async_depth=0, shard_points=False, **SIZES))
    port = TSystem(TCam.create(**ARGS), mono_slice_config(enable_fuse=True, **SIZES), device="cpu")
    # count the neighbour fuses the port's keyframe chain runs
    calls = []
    real = tlm.fuse_neighbors
    monkeypatch_module.setattr(tlm, "fuse_neighbors",
                               lambda *a, **kw: calls.append(a[2]) or real(*a, **kw))
    for k, img in enumerate(images):
        ref.track_mono(img, k / 30.0)
        port.track_mono(img, k / 30.0)
    return poses, ref, port, calls


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_fuse_slice_matches_jax_system(fuse_runs):
    poses, ref, port, calls = fuse_runs
    assert port.cfg.enable_fuse and port.cfg.stats_in_triangulate is None
    assert ref.state == "OK" and port.state == "OK"
    ate_j, n_j = ate(ref, poses)
    ate_t, n_t = ate(port, poses)
    assert n_t >= 0.7 * N_FRAMES, f"port tracked {n_t}/{N_FRAMES} (reference {n_j})"
    assert abs(port.n_keyframes - ref.n_keyframes) <= 2
    assert port.n_mappoints > 100
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.01), (ate_t, ate_j)
    assert ate_t < 0.08
    # one neighbour fuse a keyframe chain: every keyframe after the two of initialization
    assert len(calls) == int(port.map.n_kf) - 2 > 0
