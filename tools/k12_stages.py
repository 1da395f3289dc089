#!/usr/bin/env python3
"""Kernel 12's device time split by launch and phase, on the card.

    python3 tools/k12_stages.py [--root DIR] [--no-slice]

Builds a copy of the tree's ``csrc/grid_ba.cu`` (``--root``, default this
checkout) with nvcc into ``orb_slam2_annotate_tpu_torch/_build/k12_stages/``
(gitignored) with two edits, fixed strings replaced (each must match once;
the committed source holds no switch): the launcher records a CUDA event
before the first launch and after each launch, after a spinning kernel that
holds the stream until every launch of the solve is queued (so no gap of the
host's shows between them); and ``gba_chol`` reads ``%globaltimer`` in
thread 0 of each CTA at its start, after the assembly, the factorization and
the two triangular solves, and at its end (the retraction and the points'
steps), each read waiting on a value produced just before it (the last
iteration's three CTAs are kept).

On the synthetic full-width problem of ``tests/_grid_ba_cases.py`` (C 32, N
1,024, P 2,048) and, unless ``--no-slice``, on the first 4- and
6-iteration local-BA solves from the second half of ``chip_smoke.py``'s mono
slice (phase 4's capture), it prints a JSON line a problem and iteration
count: each launch kind's median and largest time (us; setup, linearize,
Schur, Cholesky, tries, mask) over the iterations, the solve's span from the
first event to the last, the Cholesky's phases (us, the slowest CTA), the
uninstrumented solve's CUDA-graph replay (``chip_smoke.graph_us``), its
bound (``chip_smoke.grid_ba_work``: bytes over 3.35 TB/s, operations over 67
T/s) and its chain floor: the solve's 2 + 4 x iters dependent launches, each
at the time of an empty kernel launched back to back (probed here).  Then the
card's name and power limit (``nvidia-smi``).  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

MAX_EV = 64          # events of one solve: 2 + 4 x iters launches + 1
CHOL_MARKS = 5       # start, assembled, factored, solved, end
TIMING = f"""
#include <cuda_runtime.h>
static cudaEvent_t k12_ev[{MAX_EV}];
static int k12_nev = 0;
__device__ long long k12_chol[3][{CHOL_MARKS}];
__global__ void k12_spin(long long ns) {{
    unsigned long long t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    do {{ asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); }} while ((long long)(t - t0) < ns);
}}
static void k12_record(cudaStream_t s) {{
    if (k12_nev < {MAX_EV}) cudaEventRecord(k12_ev[k12_nev++], s);
}}
extern "C" int k12_events_init() {{
    for (int i = 0; i < {MAX_EV}; ++i)
        if (cudaEventCreate(&k12_ev[i]) != cudaSuccess) return 1;
    return 0;
}}
// the elapsed ms between consecutive events of the last solve; returns their count
extern "C" int k12_events_read(float* ms) {{
    cudaEventSynchronize(k12_ev[k12_nev - 1]);
    for (int i = 1; i < k12_nev; ++i) cudaEventElapsedTime(&ms[i - 1], k12_ev[i - 1], k12_ev[i]);
    return k12_nev;
}}
extern "C" int k12_chol_read(long long* host) {{
    return (int)cudaMemcpyFromSymbol(host, k12_chol, sizeof(k12_chol));
}}
// an empty kernel, for the launch floor
__global__ void k12_empty() {{}}
extern "C" int k12_empty_launch(cudaStream_t s) {{
    k12_empty<<<1, 32, 0, s>>>();
    return (int)cudaGetLastError();
}}
#define K12_MARK(i, dep)                                                           \\
    if (threadIdx.x == 0) {{                                                        \\
        unsigned long long t_;                                                      \\
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_) : "r"((int)(dep)));   \\
        k12_chol[blockIdx.x][(i)] = (long long)t_;                                  \\
    }}
"""
F = "__float_as_int"
# (old text, new text): each must match once
EDITS = [
    ("enum Mode { SETUP = 0, LIN = 1, TRIES = 2, FINAL = 3 };",
     TIMING + "enum Mode { SETUP = 0, LIN = 1, TRIES = 2, FINAL = 3 };"),
    ("    if (tid == 0) s_fail = 0;\n    __syncthreads();\n\n    // assemble:",
     "    if (tid == 0) s_fail = 0;\n    __syncthreads();\n    K12_MARK(0, s_fail)\n\n    // assemble:"),
    ("    // factor: A = L L^T by blocks of NB columns\n",
     f"    K12_MARK(1, {F}(v[np - 1]))\n    // factor: A = L L^T by blocks of NB columns\n"),
    ("    // L y = v, then L^T x = y, by blocks\n",
     f"    K12_MARK(2, {F}(A[(np - 1) * lda + np - 1]))\n    // L y = v, then L^T x = y, by blocks\n"),
    ("    // the step: NaN where the factorization failed, 0 on the cameras not free\n",
     f"    K12_MARK(3, {F}(v[0]))\n"
     "    // the step: NaN where the factorization failed, 0 on the cameras not free\n"),
    ("            Xa[3 * p + j] = o.X[3 * p + j] + dp * ptv;\n        }\n    }\n}",
     "            Xa[3 * p + j] = o.X[3 * p + j] + dp * ptv;\n        }\n    }\n"
     "    __syncthreads();\n    K12_MARK(4, wk.fail[k])\n}"),
    ("    gba_grid<<<C + 1, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, SETUP, lam0);\n",
     "    k12_nev = 0;\n    k12_spin<<<1, 1, 0, stream>>>(2000000);\n    k12_record(stream);\n"
     "    gba_grid<<<C + 1, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, SETUP, lam0);\n"
     "    k12_record(stream);\n"),
    ("            cm, pb, wk, o, LIN, lam0);\n        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;\n",
     "            cm, pb, wk, o, LIN, lam0);\n        k12_record(stream);\n"
     "        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;\n"),
    ("        gba_schur<<<dim3(C, 3), SCHUR_THREADS, schur_smem, stream>>>(pb, wk, cap);\n",
     "        gba_schur<<<dim3(C, 3), SCHUR_THREADS, schur_smem, stream>>>(pb, wk, cap);\n"
     "        k12_record(stream);\n"),
    ("        gba_chol<<<3, CHOL_THREADS, csmem, stream>>>(pb, wk, o);\n",
     "        gba_chol<<<3, CHOL_THREADS, csmem, stream>>>(pb, wk, o);\n        k12_record(stream);\n"),
    ("        gba_grid<<<3 * C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, TRIES, lam0);\n",
     "        gba_grid<<<3 * C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, TRIES, lam0);\n"
     "        k12_record(stream);\n"),
    ("    gba_grid<<<C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, FINAL, lam0);\n",
     "    gba_grid<<<C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, FINAL, lam0);\n"
     "    k12_record(stream);\n"),
]
KINDS = ("linearize", "Schur", "Cholesky", "tries")
CHOL_PHASES = {"assembly": (0, 1), "factorization": (1, 2), "triangular solves": (2, 3),
               "retraction + points' steps": (3, 4), "whole CTA": (0, 4)}


def instrumented(text: str) -> str:
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"k12_stages: {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def split(ms: list, iters: int) -> dict:
    """Each launch kind's median and largest time (us) from the per-launch
    event times of one solve: setup, iters x (the four kinds), the mask."""
    us = [1e3 * x for x in ms]
    out = {"setup": [us[0], us[0]]}
    for j, kind in enumerate(KINDS):
        vals = [us[1 + 4 * i + j] for i in range(iters)]
        out[kind] = [statistics.median(vals), max(vals)]
    out["mask"] = [us[1 + 4 * iters], us[1 + 4 * iters]]
    return out


def slice_problems(cs):
    """The first 4- and 6-iteration local-BA solves from the second half of
    chip_smoke's mono slice: {iters: (camera, GridBA)}."""
    import torch

    from orb_slam2_annotate_tpu_torch.pipeline import System
    from orb_slam2_annotate_tpu_torch.solvers import ba_core

    cam, _, frames, _, cfg = cs.slice_setup()
    slam = System(cam, cfg, device="cuda")
    kept, real = {}, ba_core.bundle_adjust_grid

    def keep(c_, g, iters=10, *a, **kw):
        if slam.frame_id >= cs.N_FRAMES // 2 and iters not in kept and (iters == 4 or 4 in kept):
            kept[iters] = (c_, cs.grid_clone(g))
        return real(c_, g, iters, *a, **kw)

    ba_core.bundle_adjust_grid = keep
    try:
        for k, img in enumerate(frames):
            slam.track_mono(img, k / 30.0)
            if 6 in kept:
                break
    finally:
        ba_core.bundle_adjust_grid = real
    torch.cuda.synchronize()
    return kept


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--no-slice", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import numpy as np
    import torch

    import k4_shapes

    if not torch.cuda.is_available():
        sys.exit("k12_stages: no CUDA device")
    cs = k4_shapes.load("chip_smoke_k12", os.path.join(ROOT, "chip_smoke.py"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    k4_shapes.import_tree(root)
    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.kernels import _build
    from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12

    dev = torch.device("cuda:0")
    cases = cs.grid_ba_cases()
    problems = {"synthetic": (CameraModel.create(**cases["CAM"]),
                              cs.grid_on(cases["grid_problem"](12, *cs.GBA_CASE_SIZE), dev))}
    if not args.no_slice:
        for iters, cg in slice_problems(cs).items():
            problems[f"slice ({iters}-iteration solve)"] = cg
    with open(os.path.join(root, "orb_slam2_annotate_tpu_torch", "csrc", "grid_ba.cu")) as f:
        text = instrumented(f.read())
    out_dir = os.path.join(ROOT, "orb_slam2_annotate_tpu_torch", "_build", "k12_stages")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "grid_ba.cu")
    lib_path = os.path.join(out_dir, "libk12_stages.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.BASE_FLAGS,
                    *_build.SOURCES["grid_ba"], "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.k12_events_read.argtypes = [ctypes.c_void_p]
    lib.k12_chol_read.argtypes = [ctypes.c_void_p]
    lib.k12_empty_launch.argtypes = [ctypes.c_void_p]
    _build.check_launch(lib.k12_events_init(), "k12_events_init")
    # the launch floor: an empty kernel launched back to back
    stream = _build.stream_ptr(dev)
    floor_ms = cs.time_ms(lambda: lib.k12_empty_launch(stream), 1000)
    real_load = _build.load
    ms = (ctypes.c_float * MAX_EV)()
    chol = (ctypes.c_longlong * (3 * CHOL_MARKS))()
    for name, (cam, g) in problems.items():
        for iters in ((4, 6) if name == "synthetic" else (int(name.split("(")[1][0]),)):
            graph = cs.graph_us(lambda: k12.grid_ba_solve(cam, g, iters))
            nb, ops = cs.grid_ba_work(g, iters)
            bound_ms, bound_by = cs.bound(nb, ops)
            _build.load = lambda n: lib if n == "grid_ba" else real_load(n)
            k12._lib.cache_clear()
            try:
                for _ in range(3):
                    k12.grid_ba_solve(cam, g, iters)
                torch.cuda.synchronize()
                k12.grid_ba_solve(cam, g, iters)
                n_ev = lib.k12_events_read(ms)
                _build.check_launch(lib.k12_chol_read(chol), "k12_chol_read")
            finally:
                _build.load = real_load
                k12._lib.cache_clear()
            per = list(ms[:n_ev - 1])
            m = np.frombuffer(chol, dtype=np.int64).reshape(3, CHOL_MARKS)
            chol_us = {k: float((m[:, j] - m[:, i]).max()) / 1e3 for k, (i, j) in CHOL_PHASES.items()}
            sp = split(per, iters)
            chain_us = 1e3 * floor_ms * k12.launches_per_solve(iters)
            row = {"problem": name, "iters": iters, "C": int(g.pt_loc.shape[0]),
                   "N": int(g.pt_loc.shape[1]), "P": int(g.points.shape[0]),
                   "launch_us_median_max": sp, "span_us": 1e3 * sum(per),
                   "cholesky_us_last_iteration": chol_us, "graph_us": graph,
                   "bound_ms": bound_ms, "bound_by": bound_by, "empty_launch_us": 1e3 * floor_ms,
                   "chain_floor_us": chain_us}
            print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()
