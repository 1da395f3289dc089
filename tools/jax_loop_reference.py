#!/usr/bin/env python3
"""The JAX System on the loop cell of ``chip_smoke.py``'s phase 6, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_loop_reference.py [--qvga] [--frames N] [--async-depth N]
                                                   [--kf-culling] [--depth] [--seed S]

Scene: ``RoomScene(seed=2)`` along ``circle_trajectory(180, radius=1.8,
turns=1.04)`` (the scene of ``tests/test_e2e_loop.py``).  Default width:
640x480, fx = fy = 500, 1024 features, 8 levels, ``max_kf=128``,
``max_mp=16384``; ``--qvga`` takes the test's own 320x240, 512 features,
4 levels, ``max_kf=64``, ``max_mp=8192``.  Settings:
``max_frames_between_kf=4``, ``init_min_matches=60``,
``enable_kf_culling=False`` and ``SlamConfig()``'s own
``enable_loop_closing=True``; ``--async-depth`` pipelines the tracking
(default 0, synchronous) and ``--kf-culling`` turns keyframe culling on
(``SlamConfig()``'s own default).  ``--depth`` runs the RGB-D sensor on the
same frames with their rendered depth (bf = f x 0.08, ``th_depth=100``:
``chip_smoke.py`` phase 12's depth), so the Sim3 of loop closing has its
scale fixed and the ATE is SE3-aligned; ``--seed S`` sets ``SlamConfig.seed``
and, since the loop closer keys its two Sim3 RANSAC draws by the keyframe
count alone (``PRNGKey(n_kf)``, ``PRNGKey(n_kf + 1)``), folds S into those keys
(``jax.random.fold_in``) for S > 0, so the seeds sample the spread of the
draws; seed 0 is the reference's own keys.  Runs on one JAX device, so a global BA takes
the single-device branch.  Prints per-frame progress and, as its last line,
a JSON object: closures, global BAs dispatched and folded, tracked frames,
final state, keyframes, and the ATE (Sim3-aligned, SE3 with ``--depth``) of
the live poses and of ``frame_trajectory()`` (after the final fold).
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
from orb_slam2_annotate_tpu.pipeline import loop_closing  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--qvga", action="store_true")
    ap.add_argument("--frames", type=int, default=180)
    ap.add_argument("--async-depth", type=int, default=0)
    ap.add_argument("--kf-culling", action="store_true")
    ap.add_argument("--depth", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if args.qvga:
        w, h, f, nf, nl, mkf, mmp = 320, 240, 250.0, 512, 4, 64, 8192
    else:
        w, h, f, nf, nl, mkf, mmp = 640, 480, 500.0, 1024, 8, 128, 16384
    bf = f * 0.08 if args.depth else 0.0
    cam = CameraModel.create(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h, bf=bf)
    scene = synthetic.RoomScene(seed=2)
    poses = synthetic.circle_trajectory(180, radius=1.8, turns=1.04)[:args.frames]
    cfg = SlamConfig(n_features=nf, n_levels=nl, max_kf=mkf, max_mp=mmp,
                     max_frames_between_kf=4, init_min_matches=60,
                     enable_kf_culling=args.kf_culling, async_depth=args.async_depth,
                     seed=args.seed,
                     **(dict(sensor="rgbd", th_depth=100.0) if args.depth else {}))
    assert cfg.enable_loop_closing
    if args.seed:
        import jax

        real_ransac = loop_closing.sim3_solver.sim3_ransac

        def keyed_ransac(key, *a, **kw):
            return real_ransac(jax.random.fold_in(key, args.seed), *a, **kw)

        loop_closing.sim3_solver.sim3_ransac = keyed_ransac
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
        img, depth = scene.render(cam, R, t, h=h, w=w)
        n0 = lc.n_loops_closed
        img = np.clip(img, 0, 255).astype(np.uint8)
        T = (slam.track_rgbd(img, depth, k / 30.0) if args.depth
             else slam.track_mono(img, k / 30.0))
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
        return float(evaluation.ate_rmse(est, gt, with_scale=not args.depth)[0]), len(ids)

    ate_live, n_live = ate(live)
    ate_traj, n_traj = ate(dict(slam.frame_trajectory()))
    print(json.dumps({"width": w, "frames": len(poses), "async_depth": args.async_depth,
                      "kf_culling": args.kf_culling, "depth": args.depth, "seed": args.seed,
                      "n_loops_closed": lc.n_loops_closed,
                      "closure_frames": closures, "gba": gba, "tracked": n_live,
                      "state": slam.state, "keyframes": slam.n_keyframes,
                      "ate_live_m": ate_live, "ate_trajectory_m": ate_traj,
                      "trajectory_frames": n_traj, "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
