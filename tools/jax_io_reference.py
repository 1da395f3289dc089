#!/usr/bin/env python3
"""The JAX package on the cells of ``chip_smoke.py``'s phase 14, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/jax_io_reference.py [io] [merge] [drivers] [--dir DIR]

``io``: the JAX System on phase 5's 64-frame sweep (bench.py's VGA width,
PlaneScene(seed=1), orbit_trajectory(64, step=0.08), the port's
``mono_slice_config`` sizes), ``save_map``, a fresh System's
``load_map``, then frames 4-7: how many relocalization attempts the frames
took, and each camera centre's error against the truth once the saved
run's trajectory is Sim3-aligned to it.  ``merge``: two RGB-D sessions of phase 7's depth cell
(bf = 500 x 0.3, th_depth 100, frames 0-27 and 20-47) merged with
``merge_maps(fix_scale=True)``: success, the scale, the median error of the
merged keyframes' centres and the slots used.  ``drivers``: the fixtures of
``tools/driver_fixtures.py`` rendered by the JAX package's own
``io/synthetic`` (bit for bit the port's) at VGA, 32 frames, and
``examples/run_tum.py`` (mono on the distorted capture, and rgbd),
``run_kitti.py`` mono and ``run_euroc.py`` stereo run on them as
subprocesses, each one's Sim3-aligned ATE over its trajectory file (KITTI:
the keyframe trajectory, which has timestamps); and ``run_synthetic.py
--free``'s run, done in this process so that nothing is written to /tmp.
With no part named, all three run.  Prints a JSON line per cell and, last,
all of them in one object.  Imports nothing of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402

import driver_fixtures as fx  # noqa: E402
from orb_slam2_annotate_tpu.geometry import CameraModel  # noqa: E402
from orb_slam2_annotate_tpu.io import evaluation, synthetic  # noqa: E402
from orb_slam2_annotate_tpu.pipeline import SlamConfig, System  # noqa: E402

SIZES = dict(n_features=1024, max_kf=128, max_mp=16384, max_frames_between_kf=6,
             init_min_matches=60)
N_FRAMES = 48
SWEEP_FRAMES, SWEEP_STEP = 64, 0.08
RELOC_FRAMES = (4, 5, 6, 7)
MERGE_A, MERGE_B = range(0, 28), range(20, 48)
DRIVER_FRAMES = 32
SYNTHETIC_FRAMES = 40


def slice_cell(bf=0.0):
    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480,
                             bf=bf)
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(N_FRAMES, step=0.05)
    renders = [scene.render(cam, R, t, h=480, w=640) for R, t in poses]
    return cam, poses, [fx.to_u8(img) for img, _ in renders], [d for _, d in renders]


def centre(T):
    return -np.asarray(T[:3, :3], np.float64).T @ np.asarray(T[:3, 3], np.float64)


def io_cell(tmp: str) -> dict:
    cam = CameraModel.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(SWEEP_FRAMES, step=SWEEP_STEP)
    frames = [fx.to_u8(scene.render(cam, R, t, h=480, w=640)[0]) for R, t in poses]
    cfg = SlamConfig(enable_loop_closing=False, **SIZES)
    slam = System(cam, cfg)
    for k, img in enumerate(frames):
        slam.track_mono(img, k / 30.0)
    path = os.path.join(tmp, "map.npz")
    slam.save_map(path)
    traj = dict(slam.frame_trajectory())
    ids = [k for k, T in traj.items() if T is not None]
    s, R, t = evaluation.umeyama_alignment(np.stack([centre(traj[k]) for k in ids]),
                                           np.stack([centre(np.c_[poses[k][0], poses[k][1]])
                                                     for k in ids]))
    slam2 = System(cam, cfg)
    slam2.load_map(path)
    attempts = []
    real_reloc = slam2._try_relocalize
    slam2._try_relocalize = lambda f: attempts.append(slam2.frame_id) or real_reloc(f)
    errs = []
    for i, k in enumerate(RELOC_FRAMES):
        T = slam2.track_mono(frames[k], (SWEEP_FRAMES + i) / 30.0)
        errs.append(None if T is None else float(np.linalg.norm(
            s * R @ centre(T) + t - centre(np.c_[poses[k][0], poses[k][1]]))))
    return {"keyframes": slam.n_keyframes, "map_points": slam.n_mappoints,
            "file_bytes": os.path.getsize(path), "reloc_frames": list(RELOC_FRAMES),
            "reloc_attempts": len(attempts), "reloc_centre_err_m": errs,
            "state_after": slam2.state}


def merge_cell() -> dict:
    from orb_slam2_annotate_tpu.worldmap import merge

    cam, poses, frames, depths = slice_cell(bf=500.0 * 0.3)
    cfg = SlamConfig(sensor="rgbd", th_depth=100.0, **SIZES)

    def run(span):
        slam = System(cam, cfg)
        for k in span:
            slam.track_rgbd(frames[k], depths[k], k / 30.0)
        slam.flush()
        return slam

    a, b = run(MERGE_A), run(MERGE_B)
    t0 = time.time()
    res = merge.merge_maps(a.map, b.map, cam, vocab=a.loop_closer.vocab, fix_scale=True)
    secs = time.time() - t0
    m = res.map
    fid = np.asarray(m.kf_frame_id)
    errs = []
    for s in np.nonzero(np.asarray(m.kf_valid))[0]:
        f = int(fid[s])
        f = f - 100000 + MERGE_B[0] if f >= 100000 else f
        errs.append(float(np.linalg.norm(
            centre(np.c_[np.asarray(m.kf_R[s]), np.asarray(m.kf_t[s])])
            - centre(np.c_[poses[f][0], poses[f][1]]))))
    return {"success": bool(res.success), "scale": float(res.scale),
            "median_kf_err_m": float(np.median(errs)), "kf_a": res.kf_a, "kf_b": res.kf_b,
            "keyframes_a": a.n_keyframes, "keyframes_b": b.n_keyframes,
            "keyframe_slots_used": int(np.asarray(m.kf_valid).sum()), "merge_s_cpu": secs}


def driver_cells(root: str) -> dict:
    cells = fx.build_cells(root, synthetic, DRIVER_FRAMES)
    scripts = {"tum_mono": "run_tum.py", "tum_rgbd": "run_tum.py", "kitti_mono": "run_kitti.py",
               "euroc_stereo": "run_euroc.py"}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = {}
    for name, cell in cells.items():
        cwd = os.path.join(root, "out_" + name)
        os.makedirs(cwd, exist_ok=True)
        t0 = time.time()
        r = subprocess.run([sys.executable, os.path.join(ROOT, "examples", scripts[name]),
                            *cell["args"]], cwd=cwd, env=env, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"{name} failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
        traj = "KeyFrameTrajectory.txt" if name == "kitti_mono" else "CameraTrajectory.txt"
        est, gt = fx.matched_centres(np.loadtxt(os.path.join(cwd, traj)), cell["times"],
                                     cell["centres"])
        out[name] = {"ate_m": float(evaluation.ate_rmse(est, gt, with_scale=True)[0]),
                     "rows": len(est), "trajectory": traj, "wall_s_cpu": time.time() - t0,
                     "rectified": "rectifying with LEFT./RIGHT." in r.stdout}
        print(json.dumps({name: out[name]}), flush=True)
    out["synthetic_free"] = synthetic_free()
    return out


def synthetic_free() -> dict:
    """examples/run_synthetic.py --free's run (its camera, scene, config and
    ATE), without its trajectory file."""
    from orb_slam2_annotate_tpu.pipeline.device_loop import FreeRunner

    n = SYNTHETIC_FRAMES
    cam = CameraModel.create(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
    scene = synthetic.PlaneScene(seed=1)
    poses = synthetic.orbit_trajectory(n, step=0.06)
    cfg = SlamConfig(n_features=512, n_levels=4, max_kf=64, max_mp=8192,
                     max_frames_between_kf=8, init_min_matches=60)
    runner = FreeRunner(cam, cfg, max_frames=n)
    runner.warmup()
    for k, (R, t) in enumerate(poses):
        runner.track_mono(fx.to_u8(scene.render(cam, R, t, h=240, w=320)[0]), k / 30.0)
    out = runner.finish()
    traj = dict(out["trajectory"])
    ids = [k for k, T in traj.items() if T is not None]
    est = np.stack([centre(traj[k]) for k in ids])
    gt = np.stack([centre(np.c_[poses[k][0], poses[k][1]]) for k in ids])
    return {"ate_m": float(evaluation.ate_rmse(est, gt, with_scale=True)[0]),
            "tracked": len(ids), "frames": n, "keyframes": out["n_keyframes"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("parts", nargs="*", choices=("io", "merge", "drivers"))
    ap.add_argument("--dir", help="where the fixtures and files go (default: a temporary dir)")
    args = ap.parse_args()
    parts = args.parts or ["io", "merge", "drivers"]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = args.dir or tmp
        os.makedirs(root, exist_ok=True)
        for part in parts:
            t0 = time.time()
            results[part] = (io_cell(root) if part == "io" else merge_cell() if part == "merge"
                             else driver_cells(root))
            results[part]["part_s_cpu"] = time.time() - t0
            print(json.dumps({part: results[part]}), flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
