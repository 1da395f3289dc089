#!/usr/bin/env python3
"""The port's FreeRunner on the free-runner cells of ``chip_smoke.py``
(phases 11-13), one JSON line a run: the twin of
``tools/jax_free_reference.py`` for the port.

    python3 tools/port_free_cell.py bench|loop|loop_rgbd|rgbd|stereo [--seeds 0,1,2]
                                    [--device cuda|cpu]

The cells are tools/jax_free_reference.py's, rendered by the port's numpy
copy of the synthetic scenes (stereo pairs go to ``track_stereo`` as
rendered: they are rectified).  ``--seeds`` runs the cell once a value of
``SlamConfig.seed``, which keys the runner's draws (initialization,
relocalization, the loop stage's RANSACs), to show how far an outcome
depends on them.  Each line: tracked frames, keyframes, map points, loops
closed, live global BAs, the closure records, the Sim3-aligned ATE (and with
depth the SE3-aligned one), the run's seconds and its slowest frame; on the
card also the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel  # noqa: E402
from orb_slam2_annotate_tpu_torch.io import evaluation, synthetic  # noqa: E402
from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig  # noqa: E402
from orb_slam2_annotate_tpu_torch.pipeline.device_loop import FreeRunner  # noqa: E402

BENCH_ORBIT, BENCH_BOUNCE = 112, 48
LOOP_FRAMES = 180
DEPTH_FRAMES, BASELINE = 48, 0.3


def cell(name: str):
    """(camera, config, ground-truth poses, sensor, list of image tuples)."""
    u8 = lambda im: np.clip(im, 0, 255).astype(np.uint8)
    if name == "bench":
        cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
        cfg = SlamConfig(n_features=1024, max_kf=128, max_mp=16384, max_frames_between_kf=6,
                         init_min_matches=60)
        fwd = synthetic.orbit_trajectory(BENCH_ORBIT, step=0.05)
        scene = synthetic.PlaneScene(seed=1)
        images = [u8(scene.render(cam, R, t, h=480, w=640)[0]) for R, t in fwd]
        order = list(range(BENCH_ORBIT)) + list(range(BENCH_ORBIT - 2,
                                                      BENCH_ORBIT - 2 - BENCH_BOUNCE, -1))
        return cam, cfg, [fwd[j] for j in order], "mono", [(images[j],) for j in order]
    if name in ("loop", "loop_rgbd"):
        sensor = "mono" if name == "loop" else "rgbd"
        cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240,
                                 bf=(250.0 * 0.08 if sensor == "rgbd" else 0.0))
        kw = {} if sensor == "mono" else dict(sensor="rgbd", th_depth=100.0)
        cfg = SlamConfig(n_features=512, n_levels=4, max_kf=128, max_mp=16384,
                         max_frames_between_kf=4, init_min_matches=60, enable_loop_closing=True,
                         enable_kf_culling=False, **kw)
        poses = synthetic.circle_trajectory(LOOP_FRAMES, radius=1.8, turns=1.04)
        scene = synthetic.RoomScene(seed=2)
        frames = []
        for R, t in poses:
            img, dep = scene.render(cam, R, t, h=240, w=320)
            frames.append((u8(img),) if sensor == "mono" else (u8(img), dep))
        return cam, cfg, poses, sensor, frames
    if name in ("rgbd", "stereo"):
        cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
                                 bf=500.0 * BASELINE)
        cfg = SlamConfig(sensor=name, n_features=1024, max_kf=128, max_mp=16384,
                         max_frames_between_kf=6, init_min_matches=60, th_depth=100.0)
        poses = synthetic.orbit_trajectory(DEPTH_FRAMES, step=0.05)
        scene = synthetic.PlaneScene(seed=1)
        shift = np.array([BASELINE, 0.0, 0.0], np.float32)
        frames = []
        for R, t in poses:
            img, dep = scene.render(cam, R, t, h=480, w=640)
            other = dep if name == "rgbd" else u8(
                scene.render(cam, R, np.asarray(t, np.float32) - shift, h=480, w=640)[0])
            frames.append((u8(img), other))
        return cam, cfg, poses, name, frames
    raise SystemExit(f"unknown cell {name}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cell", choices=("bench", "loop", "loop_rgbd", "rgbd", "stereo"))
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    card = None
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu for the plain twins)")
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    else:
        torch.set_num_threads(1)
    cam, cfg0, poses, sensor, frames = cell(args.cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        runner = FreeRunner(cam, dataclasses.replace(cfg0, seed=seed), max_frames=len(frames),
                            auto_grow=False, device=args.device)
        track = {"mono": runner.track_mono, "rgbd": runner.track_rgbd,
                 "stereo": runner.track_stereo}[sensor]
        t0 = time.perf_counter()
        frame_s = []
        for k, f in enumerate(frames):
            t = time.perf_counter()
            track(*f, k / 30.0)
            frame_s.append(time.perf_counter() - t)
        runner.block()
        secs = time.perf_counter() - t0
        out = runner.finish()
        ids = [k for k, T in out["trajectory"] if T is not None]
        est = np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in out["trajectory"]
                        if T is not None]).astype(np.float64)
        gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids]).astype(np.float64)
        res = {"cell": args.cell, "seed": seed, "device": args.device, "tracked": len(ids),
               "frames": len(frames), "keyframes": out["n_keyframes"],
               "map_points": out["n_mappoints"], "n_loops_closed": out["n_loops_closed"],
               "n_gba": out["n_gba"], "closure_records": out["closure_records"].tolist(),
               "ate_sim3_m": float(evaluation.ate_rmse(est, gt, with_scale=True)[0]),
               "seconds": secs, "slowest_frame": [int(np.argmax(frame_s)), max(frame_s)],
               "card": card}
        if sensor != "mono":
            res["ate_se3_m"] = float(evaluation.ate_rmse(est, gt, with_scale=False)[0])
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
