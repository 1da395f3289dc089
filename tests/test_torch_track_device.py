"""The pipelined path's tracking step, ``track_frame_device``, against the
synchronous ``track_frame`` on inputs that take each of its branches: the
motion model accepted, the widened retry, the reference keyframe (both
motion-model searches below 20 inliers), and no velocity.

The state is the port's own System after 14 frames of the slice (PlaneScene
seed 1, 320x240, 512 features, 4 levels) and frame 14; the branches come from
turning the velocity about the camera's y axis: 0.12 rad leaves the 15-px
search 4 inliers and the 30-px one 104, 0.4 rad both below 20.  R, t, obs,
the counts and every other output must be exactly equal: the device step
picks among the same results with ``torch.where``.
"""

import numpy as np
import pytest
import torch

from orb_slam2_annotate_tpu_torch.geometry import lie
from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
from orb_slam2_annotate_tpu_torch.io import synthetic
from orb_slam2_annotate_tpu_torch.pipeline import System, mono_slice_config
from orb_slam2_annotate_tpu_torch.pipeline import tracking as tk
from orb_slam2_annotate_tpu_torch.pipeline.frame import make_frame_mono

torch.set_num_threads(1)

CAM = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
SIZES = dict(n_features=512, n_levels=4, max_kf=64, max_mp=8192, max_frames_between_kf=8,
             init_min_matches=60)


@pytest.fixture(scope="module")
def state():
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(15, step=0.06)
    slam = System(CAM, mono_slice_config(**SIZES), device="cpu")
    for k in range(14):
        slam.track_mono(scene.render(CAM, *poses[k], h=240, w=320)[0], k / 30.0)
    assert slam.state == "OK" and slam.vel is not None
    frame = make_frame_mono(slam._upload(scene.render(CAM, *poses[14], h=240, w=320)[0]), CAM,
                            slam.tab, slam.cfg.extractor)
    return slam, frame


@pytest.mark.parametrize("branch, turn, has_vel", [("motion_model", 0.0, True),
                                                   ("widened_retry", 0.12, True),
                                                   ("reference_keyframe", 0.4, True),
                                                   ("no_velocity", 0.0, False)])
def test_track_frame_device_matches_track_frame(state, branch, turn, has_vel):
    slam, frame = state
    dR = lie.so3_exp(torch.tensor([0.0, turn, 0.0]))
    vel_R, vel_t = dR @ slam.vel[0], dR @ slam.vel[1]
    args = (CAM, slam.map, frame, slam.last_frame, slam.last_obs, slam.R, slam.t, vel_R, vel_t,
            has_vel, slam.ref_kf)
    # the branch these inputs take
    R_pred, t_pred = lie.se3_compose(vel_R, vel_t, slam.R, slam.t)
    n15, n30 = (int(tk.track_with_motion_model(*args[:5], R_pred, t_pred, th=th)[3])
                for th in (15.0, 30.0))
    taken = ("no_velocity" if not has_vel else "motion_model" if n15 >= 20
             else "widened_retry" if n30 >= 20 else "reference_keyframe")
    assert taken == branch, (n15, n30)

    sync = tk.track_frame(*args)
    dev = tk.track_frame_device(*args)
    assert all(torch.is_tensor(n) and n.dim() == 0 for n in (dev.n_pre, dev.n_local, dev.n_local_kf))
    assert (int(dev.n_pre), int(dev.n_local), int(dev.n_local_kf)) == (
        sync.n_pre, sync.n_local, sync.n_local_kf)
    for name in ("R", "t", "obs", "mp_visible", "mp_found", "vel_R", "vel_t", "R_cr", "t_cr"):
        assert torch.equal(getattr(dev, name), getattr(sync, name)), name
    stats, poses = dev.host_bundle()
    assert stats.tolist() == [sync.n_pre, sync.n_local, sync.n_local_kf]
    np.testing.assert_array_equal(poses[2].numpy(), torch.cat([sync.R_cr.reshape(9), sync.t_cr]))
    assert sync.n_local >= 30
