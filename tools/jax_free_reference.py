#!/usr/bin/env python3
"""The JAX ``FreeRunner`` on the free-runner cells of ``chip_smoke.py``
(phases 11-13), on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_free_reference.py bench|loop|loop_rgbd|rgbd|stereo
                                                          [--scan] [--seed S]

Cells:

* ``bench`` (phase 11): ``bench.py``'s mono cell (``SensorBench("mono")``,
  ``bench.py:132-198``): 640x480, fx = fy = 500, ``SlamConfig(n_features=1024,
  max_kf=128, max_mp=16384, max_frames_between_kf=6, init_min_matches=60)``
  with loop closing and live global BA at their defaults, ``auto_grow=False``;
  ``PlaneScene(seed=1)`` along ``orbit_trajectory(112, step=0.05)``, then 48
  frames bouncing back over the mapped span (frames 110 down to 63).  The
  bench feeds the 48 through ``track_mono_sequence(chunk=48)``; the per-frame
  step runs the same body with the same draws (keyed by frame id), so this
  tool feeds them per frame unless ``--scan`` is given (the scan program's
  CPU compile is long).
* ``loop`` / ``loop_rgbd`` (phase 12): ``tests/test_free_running.py:168-209``'s
  ``RoomScene(seed=2)`` circle, 180 frames at 320x240, 512 features, 4 levels,
  ``max_kf=128``, ``max_mp=16384``, ``max_frames_between_kf=4``,
  ``init_min_matches=60``, loop closing on, keyframe culling off;
  ``loop_rgbd`` with the rendered depth, bf = 250 x 0.08 and ``th_depth=100``
  (``tests/test_free_running.py``'s RGB-D camera), where the loop stage fixes
  the Sim3 scale.
* ``rgbd`` / ``stereo`` (phase 13): phases 7-8's cell, ``bench.py``'s depth
  settings on the slice's 48 VGA frames: bf = 500 x 0.3, ``th_depth=100``,
  ``SlamConfig()``'s other defaults; stereo renders the right image at
  t - [0.3, 0, 0].

``--seed`` sets ``SlamConfig.seed`` (default 0), which keys the runner's
draws (initialization, relocalization, the loop stage's RANSACs).  Prints,
as its last line, a JSON object: tracked frames, keyframes, map
points, loops closed, live global BAs, the first closure record, the
Sim3-aligned ATE and, with depth, the SE3-aligned one, over
``finish()["trajectory"]``.
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
from orb_slam2_annotate_tpu.pipeline import SlamConfig  # noqa: E402
from orb_slam2_annotate_tpu.pipeline.device_loop import FreeRunner  # noqa: E402

BENCH_ORBIT, BENCH_BOUNCE = 112, 48
LOOP_FRAMES = 180
DEPTH_FRAMES, BASELINE = 48, 0.3


def bench_poses():
    """The bench's forward sweep, then frames bouncing back inside it."""
    fwd = synthetic.orbit_trajectory(BENCH_ORBIT, step=0.05)
    k, d, idx = BENCH_ORBIT - 1, -1, []
    for _ in range(BENCH_BOUNCE):
        k += d
        if k < 0:
            k, d = 1, 1
        idx.append(k)
    return fwd + [fwd[j] for j in idx]


def cell(name: str, seed: int = 0):
    """(camera, config, ground-truth poses, sensor, list of image tuples)."""
    u8 = lambda im: np.clip(im, 0, 255).astype(np.uint8)
    if name == "bench":
        cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
        cfg = SlamConfig(n_features=1024, max_kf=128, max_mp=16384, max_frames_between_kf=6,
                         init_min_matches=60, seed=seed)
        poses, scene, sensor = bench_poses(), synthetic.PlaneScene(seed=1), "mono"
        frames = [(u8(scene.render(cam, R, t, h=480, w=640)[0]),) for R, t in poses]
    elif name in ("loop", "loop_rgbd"):
        sensor = "mono" if name == "loop" else "rgbd"
        cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
                                 bf=(250.0 * 0.08 if sensor == "rgbd" else 0.0))
        kw = {} if sensor == "mono" else dict(sensor="rgbd", th_depth=100.0)
        cfg = SlamConfig(n_features=512, n_levels=4, max_kf=128, max_mp=16384,
                         max_frames_between_kf=4, init_min_matches=60, enable_loop_closing=True,
                         enable_kf_culling=False, seed=seed, **kw)
        poses = synthetic.circle_trajectory(LOOP_FRAMES, radius=1.8, turns=1.04)
        scene = synthetic.RoomScene(seed=2)
        frames = []
        for R, t in poses:
            img, dep = scene.render(cam, R, t, h=240, w=320)
            frames.append((u8(img),) if sensor == "mono" else (u8(img), dep))
    elif name in ("rgbd", "stereo"):
        sensor = name
        cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
                                 bf=500.0 * BASELINE)
        cfg = SlamConfig(sensor=sensor, n_features=1024, max_kf=128, max_mp=16384,
                         max_frames_between_kf=6, init_min_matches=60, th_depth=100.0, seed=seed)
        poses = synthetic.orbit_trajectory(DEPTH_FRAMES, step=0.05)
        scene = synthetic.PlaneScene(seed=1)
        shift = np.array([BASELINE, 0.0, 0.0], np.float32)
        frames = []
        for R, t in poses:
            img, dep = scene.render(cam, R, t, h=480, w=640)
            if sensor == "rgbd":
                frames.append((u8(img), dep))
            else:
                right = scene.render(cam, R, np.asarray(t, np.float32) - shift, h=480, w=640)[0]
                frames.append((u8(img), u8(right)))
    else:
        raise SystemExit(f"unknown cell {name}")
    return cam, cfg, poses, sensor, frames


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cell", choices=("bench", "loop", "loop_rgbd", "rgbd", "stereo"))
    ap.add_argument("--scan", action="store_true",
                    help="bench: feed the bounce frames through track_mono_sequence(chunk=48)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cam, cfg, poses, sensor, frames = cell(args.cell, args.seed)
    runner = FreeRunner(cam, cfg, max_frames=len(frames), auto_grow=False)
    track = {"mono": runner.track_mono, "rgbd": runner.track_rgbd,
             "stereo": runner.track_stereo}[sensor]
    t0 = time.time()
    n_per_frame = BENCH_ORBIT if (args.cell == "bench" and args.scan) else len(frames)
    for k in range(n_per_frame):
        track(*frames[k], k / 30.0)
        if k % 20 == 0:
            print(f"frame {k}: {time.time() - t0:.0f} s", flush=True)
    if n_per_frame < len(frames):
        runner.track_mono_sequence(np.stack([f[0] for f in frames[n_per_frame:]]),
                                   [k / 30.0 for k in range(n_per_frame, len(frames))], chunk=48)
    out = runner.finish()

    ids = [k for k, T in out["trajectory"] if T is not None]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for k, T in out["trajectory"]
                    if T is not None]).astype(np.float64)
    gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids]).astype(np.float64)
    res = {"cell": args.cell, "seed": args.seed, "sensor": sensor, "frames": len(frames), "scan": args.scan,
           "tracked": len(ids), "first_tracked": ids[0] if ids else None,
           "keyframes": out["n_keyframes"], "map_points": out["n_mappoints"],
           "n_loops_closed": out["n_loops_closed"], "n_gba": out["n_gba"],
           "n_resets": out["n_resets"], "n_kf_skipped_full": out["n_kf_skipped_full"],
           "closure_records": np.asarray(out["closure_records"]).tolist(),
           "ate_sim3_m": float(evaluation.ate_rmse(est, gt, with_scale=True)[0]),
           "seconds": time.time() - t0}
    if sensor != "mono":
        res["ate_se3_m"] = float(evaluation.ate_rmse(est, gt, with_scale=False)[0])
    print(json.dumps(res))


if __name__ == "__main__":
    main()
