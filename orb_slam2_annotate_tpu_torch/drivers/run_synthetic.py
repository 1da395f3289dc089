"""Driver for a synthetic monocular sequence (port of
examples/run_synthetic.py): the reference's driver loop (frames into the
System, timed, then the trajectory and its ATE) on the built-in renderer's
orbit over PlaneScene(seed=1) at 320x240.

    python -m orb_slam2_annotate_tpu_torch.drivers.run_synthetic [n_frames] [--free]
      [--verbose] [--fuse] [--no-cull] [--no-ba] [--device cuda|cpu]

--free runs the free runner (pipeline/device_loop.FreeRunner) instead of
the System.  The trajectory goes to synthetic_traj.txt (TUM format) in the
current directory.  As a script it fails unless more than 60% of the frames
are tracked with a Sim3-aligned ATE below 0.10 m.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np

from ..geometry.camera import CameraModel
from ..io import evaluation, synthetic, trajectory
from ..pipeline import SlamConfig, System

TRAJECTORY_FILE = "synthetic_traj.txt"


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    p.add_argument("n_frames", nargs="?", type=int, default=40)
    for flag in ("--free", "--verbose", "--fuse", "--no-cull", "--no-ba"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return p.parse_args(argv)


def _ate(traj: dict, poses):
    ids = [k for k, T in traj.items() if T is not None]
    est_c = np.stack([-traj[k][:3, :3].T @ traj[k][:3, 3] for k in ids])
    gt_c = np.stack([-poses[k][0].T @ poses[k][1] for k in ids])
    rmse, _ = evaluation.ate_rmse(est_c.astype(np.float64), gt_c.astype(np.float64),
                                  with_scale=True)
    trajectory.save_tum(TRAJECTORY_FILE, [(k / 30.0, traj[k]) for k in ids])
    return float(rmse), ids, gt_c


def main(argv=None) -> dict:
    a = parse_args(argv)
    n = a.n_frames
    cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(n, step=0.06)
    cfg = SlamConfig(n_features=512, n_levels=4, max_kf=64, max_mp=8192,
                     max_frames_between_kf=8, init_min_matches=60, verbose=a.verbose,
                     enable_fuse=a.fuse, enable_cull=not a.no_cull,
                     enable_local_ba=not a.no_ba)
    frames = [np.clip(scene.render(cam, R, t, h=240, w=320)[0], 0, 255).astype(np.uint8)
              for R, t in poses]

    if a.free:
        from ..pipeline.device_loop import FreeRunner

        runner = FreeRunner(cam, cfg, max_frames=n, device=a.device)
        runner.warmup()
        t0 = time.perf_counter()
        for k, img in enumerate(frames):
            runner.track_mono(img, k / 30.0)
        runner.block()
        dt = time.perf_counter() - t0
        out = runner.finish()
        rmse, ids, _ = _ate(dict(out["trajectory"]), poses)
        print(f"free-running: {n} frames in {dt:.3f}s ({n / dt:.1f} fps), tracked {len(ids)}, "
              f"{out['n_keyframes']} keyframes, {out['n_loops_closed']} loops")
        print(f"ATE RMSE (Sim3-aligned): {rmse * 100:.2f} cm")
        return {"ate_m": rmse, "tracked": len(ids), "frames": n, "frames_per_s": n / dt,
                "keyframes": out["n_keyframes"], "loops_closed": out["n_loops_closed"]}

    slam = System(cam, cfg, device=a.device)
    times = []
    for k, img in enumerate(frames):
        t0 = time.perf_counter()
        T = slam.track_mono(img, k / 30.0)
        times.append(time.perf_counter() - t0)
        status = "ok" if T is not None else slam.state
        print(f"frame {k:3d}  {status:>16s}  kf={slam.n_keyframes:3d} "
              f"mp={slam.n_mappoints:5d}  {times[-1] * 1e3:7.1f} ms")
    rmse, ids, gt_c = _ate(dict(slam.frame_trajectory()), poses)
    med = statistics.median(times[5:] if len(times) > 5 else times)
    print(f"\ntracked {len(ids)}/{n} frames, {slam.n_keyframes} keyframes, "
          f"{slam.n_mappoints} map points")
    print(f"ATE RMSE (Sim3-aligned): {rmse * 100:.2f} cm over "
          f"{np.linalg.norm(gt_c[-1] - gt_c[0]):.2f} m trajectory")
    print(f"median frame time: {med * 1e3:.1f} ms")
    print(f"trajectory written to {TRAJECTORY_FILE}")
    return {"ate_m": rmse, "tracked": len(ids), "frames": n, "frame_ms_median": 1e3 * med,
            "frames_per_s": n / sum(times), "keyframes": slam.n_keyframes}


if __name__ == "__main__":
    r = main()
    if r["tracked"] <= 0.6 * r["frames"]:
        sys.exit(f"tracked only {r['tracked']}/{r['frames']}")
    if r["ate_m"] >= 0.10:
        sys.exit(f"ATE {r['ate_m']}")
    print("OK")
