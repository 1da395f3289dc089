#!/usr/bin/env python3
"""The dense ``ba_core.bundle_adjust`` and the distributed BA (a world of
one over two blocks) on the card, their times and their bits against the
CPU's, on a synthetic global-BA problem of ``chip_smoke.py`` phase 15's
size.

    python3 tools/dense_ba_times.py [--root DIR] [--iters 10] [--reps 3] [--no-cpu]

``--root`` imports the port from another checkout (an unpacked parent, to
compare two trees in one call: parent, change, change, parent).  The problem
(a seed, numpy): 128 cameras on a circle of radius 6 m looking at its
centre, the first two fixed, 8,192 points in a 4 m cube around it, each
seen by the 3 cameras nearest its bearing (24,576 edges, a third stereo:
phase 15's closure map holds 8,196 live points and 26,681 edges),
0.5 px of noise, the poses and points moved off their truth by 1e-3 rad /
2 cm / 2 cm.  It prints one JSON line: the dense BA's LM step's and whole
solve's host ms (the card drained around each call; the median of
``--reps``), the whole solve's CUDA-event ms, the launches a solve of each
kernel, the cost before and after, whether the card's returned state and
cost equal the CPU's bit for bit and the CPU's seconds (not with
``--no-cpu``), and from a ``torch.profiler`` trace of one more solve the
device time of all its kernels and of the dense / LU solve kernels (K12b /
K12c, ``SOLVER_KERNELS``), beside the solve's host span; the same for the
distributed BA (``dist_``); then the card's name and power limit
(``nvidia-smi``).  Needs a card (and nvcc for the kernels).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

K, P, OBS = 128, 8192, 3
SOLVER_KERNELS = ("chol_panel", "chol_back", "chol_tri", "lu_step", "lu_back", "lu_panel",
                  "lu_update", "lu_tri")


def problem(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(K) / K
    centres = np.stack([6 * np.cos(ang), 0.3 * np.sin(3 * ang), 6 * np.sin(ang)], 1)
    z = -centres / np.linalg.norm(centres, axis=1, keepdims=True)   # looking at the centre
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    R = np.stack([x, y, z], 1)                                        # rows: camera axes
    t = -np.einsum("kij,kj->ki", R, centres)
    X = rng.uniform(-2, 2, (P, 3))
    bearing = np.arctan2(X[:, 2], X[:, 0])
    near = np.argsort(np.abs(np.angle(np.exp(1j * (ang[None, :] - bearing[:, None] - np.pi)))),
                      axis=1)[:, :OBS]
    cam_idx = near.reshape(-1).astype(np.int32)
    pt_idx = np.repeat(np.arange(P), OBS).astype(np.int32)
    xc = np.einsum("eij,ej->ei", R[cam_idx], X[pt_idx]) + t[cam_idx]
    fx = fy = 500.0
    cx, cy, bf = 320.0, 240.0, 40.0
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx, fy * xc[:, 1] / xc[:, 2] + cy], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    stereo = rng.random(len(cam_idx)) < 1 / 3
    ur = np.where(stereo, uv[:, 0] - bf / xc[:, 2] + rng.normal(0, 0.5, len(cam_idx)), -1.0)
    dphi = rng.normal(0, 1e-3, (K, 3))
    dR = np.stack([np.eye(3) + np.array([[0, -p[2], p[1]], [p[2], 0, -p[0]], [-p[1], p[0], 0]])
                   for p in dphi])
    fixed = np.zeros(K, bool)
    fixed[:2] = True
    R0 = np.where(fixed[:, None, None], R, dR @ R)
    t0 = np.where(fixed[:, None], t, t + rng.normal(0, 0.02, (K, 3)))
    f32 = np.float32
    return {"cam": (fx, fy, cx, cy, bf),
            "prob": {"R": R0.astype(f32), "t": t0.astype(f32),
                     "points": (X + rng.normal(0, 0.02, X.shape)).astype(f32),
                     "cam_fixed": fixed, "cam_valid": np.ones(K, bool),
                     "pt_valid": np.ones(P, bool), "cam_idx": cam_idx, "pt_idx": pt_idx,
                     "uv": uv.astype(f32), "ur": ur.astype(f32),
                     "inv_sigma2": np.ones(len(cam_idx), f32),
                     "edge_valid": np.ones(len(cam_idx), bool)}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-cpu", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from orb_slam2_annotate_tpu_torch import convert, kernels
    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.parallel import dist_ba, mesh
    from orb_slam2_annotate_tpu_torch.solvers import ba_core

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    d = problem()
    cam = CameraModel(*d["cam"][:4], bf=d["cam"][4])
    prob = convert.ba_problem_from_numpy(d["prob"], device="cuda")
    prob_c = convert.ba_problem_from_numpy(d["prob"], device="cpu")
    torch.set_num_threads(os.cpu_count() or 1)

    def host_ms(fn):
        ts, r = [], None
        for _ in range(a.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return r, statistics.median(ts)

    def device_ms(solve):
        """One solve under torch.profiler: the host span, the device time of all its
        kernels and of the dense / LU solve kernels (either tree's names)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            span = 1e3 * (time.perf_counter() - t0)
        evs = [e for e in prof.events() if e.device_type.name == "CUDA"]
        dev = lambda es: 1e-3 * sum(e.device_time for e in es)
        return {"profiled_host_ms": span, "device_kernels_ms": dev(evs),
                "device_solver_kernels_ms": dev([e for e in evs if any(
                    k in e.name for k in SOLVER_KERNELS)])}

    def measure(solve, solve_c, one_step=None):
        """Times, launches and bits of `solve` (card) against `solve_c` (CPU)."""
        solve()                                              # builds the kernels
        row = {}
        if one_step is not None:
            row["step_host_ms"] = host_ms(one_step)[1]
        for w in kernels.WRAPPERS:
            w.launches = 0
        out, row["solve_host_ms"] = host_ms(solve)
        row["launches_a_solve"] = {w.__name__: w.launches // a.reps for w in kernels.WRAPPERS
                                   if w.launches}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        solve()
        ev[1].record()
        ev[1].synchronize()
        row["solve_event_ms"] = ev[0].elapsed_time(ev[1])
        row.update(device_ms(solve))
        row["card_equals_cpu_bit_for_bit"] = row["cpu_s"] = None
        if not a.no_cpu:
            t0 = time.perf_counter()
            out_c = solve_c()
            row["cpu_s"] = time.perf_counter() - t0
            bits = lambda x: x.cpu().view(torch.int32) if x.dtype == torch.float32 else x.cpu()
            row["card_equals_cpu_bit_for_bit"] = all(torch.equal(bits(u), bits(v))
                                                     for u, v in zip(out, out_c))
        return out, row

    out, dense = measure(lambda: ba_core.bundle_adjust(cam, prob, a.iters),
                         lambda: ba_core.bundle_adjust(cam, prob_c, a.iters),
                         lambda: ba_core.bundle_adjust(cam, prob, 1))
    one = mesh.Mesh(None, 1, 0)
    sp, sp_c = dist_ba.shard_ba_problem(prob, 2), dist_ba.shard_ba_problem(prob_c, 2)
    step = dist_ba.make_distributed_ba(one, iters=a.iters, shards=2)
    out_d, dist = measure(lambda: step(cam, sp), lambda: step(cam, sp_c))
    print(json.dumps({"root": os.path.abspath(a.root), "cameras": K, "points": P,
                      "edges": int(prob.edge_valid.sum()), "iters": a.iters, **dense,
                      "cost_before": float(ba_core.edge_cost(cam, prob)),
                      "cost_after": float(out[4]),
                      **{f"dist_{k}": v for k, v in dist.items()},
                      "dist_cost": float(out_d[3])}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
