#!/usr/bin/env python3
"""The JAX System on the RGB-D and stereo cells of ``chip_smoke.py``'s
phases 7 and 8, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_depth_reference.py rgbd|stereo [--frames N]

The cell is ``bench.py``'s (``bench.py:151-196``): 640x480, fx = fy = 500,
bf = 500 x 0.3, ``SlamConfig(sensor=..., n_features=1024, max_kf=128,
max_mp=16384, max_frames_between_kf=6, init_min_matches=60,
th_depth=100.0)`` with every other field at its default (8 levels; loop
closing, relocalization and keyframe culling on), on ``PlaneScene(seed=1)``
along ``orbit_trajectory(48, step=0.05)``, uint8 frames.  RGB-D takes the
rendered depth; stereo renders the right image at ``t - [0.3, 0, 0]``.
Prints per-frame progress and, as its last line, a JSON object: tracked
frames, final state, keyframes, map points, and over ``frame_trajectory()``
the SE3-aligned ATE (no scale: depth makes it metric), the end-to-end
displacement ratio and the path-length ratio against the truth.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from orb_slam2_annotate_tpu.geometry import CameraModel  # noqa: E402
from orb_slam2_annotate_tpu.io import evaluation, synthetic  # noqa: E402
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System  # noqa: E402

BASELINE = 0.3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sensor", choices=("rgbd", "stereo"))
    ap.add_argument("--frames", type=int, default=48)
    args = ap.parse_args()
    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
                             bf=500.0 * BASELINE)
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(args.frames, step=0.05)
    cfg = SlamConfig(sensor=args.sensor, n_features=1024, max_kf=128, max_mp=16384,
                     max_frames_between_kf=6, init_min_matches=60, th_depth=100.0)
    slam = System(cam, cfg)
    u8 = lambda im: np.clip(im, 0, 255).astype(np.uint8)
    t0 = time.time()
    for k, (R, t) in enumerate(poses):
        img, dep = scene.render(cam, R, t, h=480, w=640)
        if args.sensor == "rgbd":
            slam.track_rgbd(u8(img), dep, k / 30.0)
        else:
            t_r = np.asarray(t, np.float32) - np.array([BASELINE, 0, 0], np.float32)
            slam.track_stereo(u8(img), u8(scene.render(cam, R, t_r, h=480, w=640)[0]), k / 30.0)
        print(f"frame {k}: {slam.state} kf {slam.n_keyframes} points {slam.n_mappoints} "
              f"{time.time() - t0:.0f} s", flush=True)
    traj = dict(slam.frame_trajectory())
    ids = sorted(k for k, T in traj.items() if T is not None)
    est = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids]).astype(np.float64)
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids]).astype(np.float64)
    path = lambda c: float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
    print(json.dumps({
        "sensor": args.sensor, "frames": len(poses), "tracked": len(ids), "state": slam.state,
        "keyframes": slam.n_keyframes, "map_points": slam.n_mappoints,
        "ate_se3_m": float(evaluation.ate_rmse(est, gt, with_scale=False)[0]),
        "displacement_ratio": float(np.linalg.norm(est[-1] - est[0]) / np.linalg.norm(gt[-1] - gt[0])),
        "path_ratio": path(est) / path(gt), "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
