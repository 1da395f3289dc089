#!/usr/bin/env python3
"""The port's System on the loop cell of ``chip_smoke.py``'s phase 6,
synchronous and pipelined, keyframe culling on and off.

    python3 tools/port_loop_cell.py [--device cuda|cpu] [--runs sync,async,...]
                                    [--frames N] [--seeds 0,1,...] [--drain]

Scene and settings as ``tools/jax_loop_reference.py --qvga``:
``RoomScene(seed=2)`` along ``circle_trajectory(180, radius=1.8,
turns=1.04)``, 320x240, 512 features, 4 levels, ``max_kf=64``,
``max_mp=8192``, ``max_frames_between_kf=4``, ``init_min_matches=60``,
``SlamConfig()``'s other defaults (loop closing on).  Runs: ``sync``,
``async`` (``async_depth=2``), each with keyframe culling on, and
``sync_nocull``, ``async_nocull`` with it off.  ``--seeds`` runs each
once a seed S: ``SlamConfig.seed`` S and, for S > 0, S folded into the
loop closer's Sim3 RANSAC draws (as ``tools/jax_loop_reference.py --seed S``
folds it into the reference's keys), so the seeds sample the spread of the
draws; seed 0 is the System's own.  ``--drain`` waits for the card after
each global BA's dispatch, so the BA folds at the keyframe that closed the
loop, as in ``chip_smoke.py``'s phase 6 (``sync_nocull --drain`` is phase
6's run).  Prints one JSON line a run: final state, keyframes, loops
closed, frames with a pose, the Sim3-aligned ATE, the frames that ended
their call not ``OK``, and every keyframe cull applied (the frame, the
caller, the slots dropped).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel  # noqa: E402
from orb_slam2_annotate_tpu_torch.io import evaluation, synthetic  # noqa: E402
from orb_slam2_annotate_tpu_torch.pipeline import SlamConfig, System  # noqa: E402
from orb_slam2_annotate_tpu_torch.solvers import sim3 as sim3_solver  # noqa: E402

RUNS = {"sync": (True, 0), "async": (True, 2), "sync_nocull": (False, 0),
        "async_nocull": (False, 2)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", default="sync,async")
    ap.add_argument("--frames", type=int, default=180)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--drain", action="store_true")
    args = ap.parse_args()
    real_ransac = sim3_solver.sim3_ransac
    cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    scene = synthetic.RoomScene(seed=2)
    poses = synthetic.circle_trajectory(180, radius=1.8, turns=1.04)[:args.frames]
    frames = [np.clip(scene.render(cam, R, t, h=240, w=320)[0], 0, 255).astype(np.uint8)
              for R, t in poses]
    for name, seed in [(n, int(s)) for n in args.runs.split(",") for s in args.seeds.split(",")]:
        culling, depth = RUNS[name]
        cfg = SlamConfig(n_features=512, n_levels=4, max_kf=64, max_mp=8192,
                         max_frames_between_kf=4, init_min_matches=60,
                         enable_kf_culling=culling, async_depth=depth, seed=seed)

        def ransac(gen, *a, seed=seed, **kw):
            gen.manual_seed(gen.initial_seed() * 1_000_003 + seed)
            return real_ransac(gen, *a, **kw)

        sim3_solver.sim3_ransac = ransac if seed else real_ransac
        slam = System(cam, cfg, device=args.device)
        if args.drain:
            lc, real_gba = slam.loop_closer, slam.loop_closer._dispatch_global_ba

            def drained(m, anchor, real_gba=real_gba, lc=lc):
                real_gba(m, anchor)
                if lc._gba_pending["done"] is not None:
                    lc._gba_pending["done"].synchronize()

            lc._dispatch_global_ba = drained
        culls, real = [], slam._apply_cull_info

        def apply(info, culls=culls, real=real, slam=slam):
            culls.append((slam.frame_id, sys._getframe(1).f_code.co_name,
                          info.slots[info.ok].tolist()))
            return real(info)

        slam._apply_cull_info = apply
        not_ok, t0 = [], time.time()
        for k, img in enumerate(frames):
            slam.track_mono(img, k / 30.0)
            if slam.state != "OK":
                not_ok.append(k)
        slam.flush()
        traj = dict(slam.frame_trajectory())
        ids = [k for k, T in traj.items() if T is not None]
        est = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids]).astype(np.float64)
        gt = np.stack([-poses[k][0].T @ poses[k][1] for k in ids]).astype(np.float64)
        print(json.dumps({"run": name, "seed": seed, "drain": args.drain,
                          "device": args.device, "state": slam.state,
                          "keyframes": slam.n_keyframes,
                          "loops_closed": slam.loop_closer.n_loops_closed, "tracked": len(ids),
                          "ate_m": float(evaluation.ate_rmse(est, gt, with_scale=True)[0]),
                          "not_ok_frames": not_ok, "culls": culls,
                          "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
