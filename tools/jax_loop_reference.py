#!/usr/bin/env python3
"""The JAX System on the loop cell of ``chip_smoke.py``'s phase 6, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_loop_reference.py [--qvga] [--frames N]

Scene: ``RoomScene(seed=2)`` along ``circle_trajectory(180, radius=1.8,
turns=1.04)`` (the scene of ``tests/test_e2e_loop.py``).  Default width:
640x480, fx = fy = 500, 1024 features, 8 levels, ``max_kf=128``,
``max_mp=16384``; ``--qvga`` takes the test's own 320x240, 512 features,
4 levels, ``max_kf=64``, ``max_mp=8192``.  Settings:
``max_frames_between_kf=4``, ``init_min_matches=60``,
``enable_kf_culling=False`` and ``SlamConfig()``'s own
``enable_loop_closing=True``.  Runs on one JAX device, so a global BA takes
the single-device branch.  Prints per-frame progress and, as its last line,
a JSON object: closures, global BAs dispatched and folded, tracked frames,
final state, keyframes, and the Sim3-aligned ATE of the live poses and of
``frame_trajectory()`` (after the final fold).
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--qvga", action="store_true")
    ap.add_argument("--frames", type=int, default=180)
    args = ap.parse_args()
    if args.qvga:
        w, h, f, nf, nl, mkf, mmp = 320, 240, 250.0, 512, 4, 64, 8192
    else:
        w, h, f, nf, nl, mkf, mmp = 640, 480, 500.0, 1024, 8, 128, 16384
    cam = CameraModel.create(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)
    scene = synthetic.RoomScene(seed=2)
    poses = synthetic.circle_trajectory(180, radius=1.8, turns=1.04)[:args.frames]
    cfg = SlamConfig(n_features=nf, n_levels=nl, max_kf=mkf, max_mp=mmp,
                     max_frames_between_kf=4, init_min_matches=60, enable_kf_culling=False)
    assert cfg.enable_loop_closing
    slam = System(cam, cfg)
    lc = slam.loop_closer
    gba = {"dispatched": 0, "folded": 0}
    real_dispatch, real_fold = lc._dispatch_global_ba, lc.maybe_fold_gba

    def dispatch(m, anchor):
        gba["dispatched"] += 1
        return real_dispatch(m, anchor)

    def fold(m, force=False):
        pending = lc._gba_pending is not None
        out = real_fold(m, force)
        gba["folded"] += int(pending and lc._gba_pending is None)
        return out

    lc._dispatch_global_ba, lc.maybe_fold_gba = dispatch, fold
    live, closures = {}, []
    t0 = time.time()
    for k, (R, t) in enumerate(poses):
        img, _ = scene.render(cam, R, t, h=h, w=w)
        n0 = lc.n_loops_closed
        T = slam.track_mono(np.clip(img, 0, 255).astype(np.uint8), k / 30.0)
        if lc.n_loops_closed > n0:
            closures.append(k)
        if T is not None:
            live[k] = np.asarray(T)
        print(f"frame {k}: {slam.state} kf {slam.n_keyframes} loops {lc.n_loops_closed} "
              f"{time.time() - t0:.0f} s", flush=True)
    slam.flush()

    def ate(traj):
        ids = sorted(k for k, T in traj.items() if T is not None)
        est = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids]).astype(np.float64)
        gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids]).astype(np.float64)
        return float(evaluation.ate_rmse(est, gt, with_scale=True)[0]), len(ids)

    ate_live, n_live = ate(live)
    ate_traj, n_traj = ate(dict(slam.frame_trajectory()))
    print(json.dumps({"width": w, "frames": len(poses), "n_loops_closed": lc.n_loops_closed,
                      "closure_frames": closures, "gba": gba, "tracked": n_live,
                      "state": slam.state, "keyframes": slam.n_keyframes,
                      "ate_live_m": ate_live, "ate_trajectory_m": ate_traj,
                      "trajectory_frames": n_traj, "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
