#!/usr/bin/env python3
"""Kernel 4's device time split by phase, on the card.

    python3 tools/k4_stages.py [--root DIR] [--design slots|compact]

Builds a copy of the tree's ``csrc/pose_lm.cu`` (``--root``, default this
checkout) with nvcc into ``orb_slam2_annotate_tpu_torch/_build/k4_stages/``
(gitignored) in which the kernel reads ``%globaltimer`` at fixed points,
each read waiting on a value produced just before it.  The committed source
holds no switch: the copy is the text with fixed strings replaced, and each
replacement must match exactly once.  ``--design`` names the kernel's
layout: ``slots`` the first design (one CTA of 256 threads over all N slots,
one thread a ladder value), ``compact`` the present one.  Lane 0 of every warp
records each mark of each LM iteration and of each round's
reclassification; a mark's time is the latest over the warps.  The phases:

- slots: (a) the pass over the slots, its 28 sums (``block_sum``: shuffles
  and two barriers), (b) the ladder's solve and retract and their barrier,
  (c) the candidates' pass, its three sums, (d) the pick and its barrier;
- compact: (a) the pass over the compacted edges (recorded only where it runs:
  it is skipped after a refused step; at a round's first iteration it also
  sums the cost and, after round 1, reclassifies), the warp butterfly and
  the barrier, (b) the ladder warps' cross-warp sums (none after a refused
  step), the solve, the retract and the barrier, (c) the candidates' pass,
  its warp sums and the barrier, (d) the pick (lanes 0-2 sum the costs over
  the warps, the pose update);

and the reclassification ending each round (compact: the last round's; an
earlier one is its successor's first pass).  The chain floor is 20 x the
least sum, over the iterations, of the phases no edge count shortens: the
reductions, the barriers and the ladder.  On three of
``tools/k4_shapes.py``'s shapes (the local-map call, the RGB-D call, the B =
8 synthetic call; at most eight problems recorded), one call after three
warm-up calls, it prints a JSON line a shape: the median and 90th percentile
of each phase (ns) over the iterations (and problems), the call's span from
the first mark to the last, and the uninstrumented kernel's CUDA-graph replay
time (chip_smoke.graph_us).  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

MB, MI, NM, MW = 8, 32, 10, 32       # problems, iteration slots, marks, warps recorded
MARKS = f"""__device__ long long k4_marks[{MB}][{MI}][{NM}][{MW}];
extern "C" int k4_marks_read(long long* host) {{
    return (int)cudaMemcpyFromSymbol(host, k4_marks, sizeof(k4_marks));
}}
extern "C" int k4_marks_clear() {{
    static long long zero[{MB}][{MI}][{NM}][{MW}];
    return (int)cudaMemcpyToSymbol(k4_marks, zero, sizeof(zero));
}}
// the time, read once `dep` has landed, as mark i of iteration slot s, by
// lane 0 of each warp of the first {MB} problems
#define K4_MARK(s, i, dep)                                                         \\
    if ((threadIdx.x & 31) == 0 && blockIdx.x < {MB} && (s) < {MI}) {{             \\
        unsigned long long t_;                                                    \\
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_) : "r"((int)(dep)));   \\
        k4_marks[blockIdx.x][(s)][(i)][threadIdx.x >> 5] = (long long)t_;         \\
    }}
#define MARK(i, dep) K4_MARK(round * iters + it, i, dep)
#define MARKR(i, dep) K4_MARK(rounds * iters + round, i, dep)
"""
F = "__float_as_int"
# (old text, new text): each must match once
EDITS = {
    "slots": [
        ("__global__ void __launch_bounds__(NT) pose_lm_solve(",
         MARKS + "__global__ void __launch_bounds__(NT) pose_lm_solve("),
        ("            // (a) linearize at the current pose\n",
         f"            // (a) linearize at the current pose\n            MARK(0, {F}(st.pose[0]))\n"),
        ("            block_sum<NACC>(acc, st, st.red);\n",
         f"            MARK(1, {F}(acc[0]))\n            block_sum<NACC>(acc, st, st.red);\n"
         f"            MARK(2, {F}(st.red[0]))\n"),
        ("            // (c) the three candidates' costs\n",
         f"            // (c) the three candidates' costs\n            MARK(3, {F}(st.cand[0][0]))\n"),
        ("            block_sum<3>(cacc, st, st.cred);\n",
         f"            MARK(4, {F}(cacc[0]))\n            block_sum<3>(cacc, st, st.cred);\n"
         f"            MARK(5, {F}(st.cred[0]))\n"),
        ("                st.lam = fminf(fmaxf(lam, 1e-9f), 1e6f);\n            }\n"
         "            __syncthreads();\n",
         "                st.lam = fminf(fmaxf(lam, 1e-9f), 1e6f);\n            }\n"
         f"            __syncthreads();\n            MARK(6, {F}(st.lam))\n"),
        ("        // chi2 reclassification\n",
         f"        // chi2 reclassification\n        MARKR(0, {F}(st.pose[0]))\n"),
        ("            mask[n] = inl ? 1 : 0;\n        }\n        __syncthreads();\n",
         "            mask[n] = inl ? 1 : 0;\n        }\n        __syncthreads();\n"
         "        MARKR(1, mask[tid])\n"),
    ],
    "compact": [
        ("template <int NT>\n__global__ void __launch_bounds__(NT) pose_lm_solve(",
         MARKS + "template <int NT>\n__global__ void __launch_bounds__(NT) pose_lm_solve("),
        ("            // (a) linearize at the current pose, unless the last step was\n",
         f"            MARK(0, {F}(P[0]))\n"
         "            // (a) linearize at the current pose, unless the last step was\n"),
        ("                // the warp's 28 sums, one a lane\n",
         f"                // the warp's 28 sums, one a lane\n                MARK(1, {F}(acc[0]))\n"),
        ("            // (b) the damping ladder: a warp a lambda\n",
         "            // (b) the damping ladder: a warp a lambda\n"
         f"            MARK(2, {F}(st.part[0][0]))\n"),
        ("                const float lam_k = lam * c_ladder[warp];\n",
         f"                MARK(3, {F}(L.red[0]))\n"
         "                const float lam_k = lam * c_ladder[warp];\n"),
        ("                solve6_warp(L, Damped{L.red, lam_k}, lane, dx);\n",
         "                solve6_warp(L, Damped{L.red, lam_k}, lane, dx);\n"
         f"                MARK(4, {F}(dx[0]))\n"),
        ("                if (lane < 12) st.cand[warp][lane] = out;\n",
         "                if (lane < 12) st.cand[warp][lane] = out;\n"
         f"                MARK(5, {F}(out))\n"),
        ("            // (c) the three candidates' costs\n",
         f"            MARK(6, {F}(cost))\n            // (c) the three candidates' costs\n"),
        ("            // the warp's three sums: cost k in lanes 8k .. 8k + 7\n",
         "            // the warp's three sums: cost k in lanes 8k .. 8k + 7\n"
         f"            MARK(7, {F}(cacc[0]))\n"),
        ("            // (d) accept the first improving lambda, in every thread: lanes 0-2\n",
         f"            MARK(8, {F}(st.cpart[0][0]))\n"
         "            // (d) accept the first improving lambda, in every thread: lanes 0-2\n"),
        ("            lam = fminf(fmaxf(lam, 1e-9f), 1e6f);\n",
         f"            lam = fminf(fmaxf(lam, 1e-9f), 1e6f);\n            MARK(9, {F}(lam))\n"),
        ("        // chi2 reclassification, on the thread's own edges, after the last\n",
         "        // chi2 reclassification, on the thread's own edges, after the last\n"
         f"        MARKR(0, {F}(P[0]))\n"),
        ("e.depth_ok ? 1 : 0;\n        }\n",
         "e.depth_ok ? 1 : 0;\n        }\n"
         "        MARKR(1, nv)\n"),
    ],
}
# phase: (first mark, last mark)
PHASES = {
    "slots": {"(a) pass": (0, 1), "(a) block_sum": (1, 2), "(b) solve + retract + barrier": (2, 3),
            "(c) pass": (3, 4), "(c) block_sum": (4, 5), "(d) pick + barrier": (5, 6),
            "iteration": (0, 6)},
    "compact": {"(a) pass": (0, 1), "(a) butterfly + barrier": (1, 2), "(b) cross-warp sums": (2, 3),
             "(b) solve6": (3, 4), "(b) retract": (4, 5), "(b) barrier": (5, 6), "(c) pass": (6, 7),
             "(c) warp sums + barrier": (7, 8), "(d) pick": (8, 9), "iteration": (0, 9)},
}
# the phases of an iteration that no edge count shortens: its reductions,
# barriers and ladder (the chain floor is 20 x their least sum)
CHAIN = {"slots": [(1, 2), (2, 3), (4, 5), (5, 6)], "compact": [(1, 2), (2, 6), (7, 8), (8, 9)]}


def instrumented(text: str, design: str) -> str:
    for old, new in EDITS[design]:
        if text.count(old) != 1:
            raise RuntimeError(f"k4_stages: {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def phase_stats(m, design: str, n_iter: int, n_rounds: int) -> dict:
    """Median and p90 (ns) of each phase over the recorded iterations and
    problems; m [MB, MI, NM, MW] of marks (0: not recorded)."""
    import numpy as np

    rec = m.max(axis=3)                                   # the latest warp's mark
    live = [b for b in range(MB) if rec[b, 0, 0] > 0]
    out = {}
    for name, (i, j) in PHASES[design].items():
        d = np.array([rec[b, s, j] - rec[b, s, i] for b in live for s in range(n_iter)
                      if rec[b, s, i] > 0 and rec[b, s, j] > 0], dtype=np.float64)
        out[name] = [float(np.median(d)), float(np.percentile(d, 90))] if len(d) else None
    d = np.array([rec[b, n_iter + r, 1] - rec[b, n_iter + r, 0] for b in live
                  for r in range(n_rounds) if rec[b, n_iter + r, 0] > 0], dtype=np.float64)
    out["reclassification (a round)"] = [float(np.median(d)), float(np.percentile(d, 90))] \
        if len(d) else None
    chain = [sum(rec[b, s, j] - rec[b, s, i] for i, j in CHAIN[design]
                 if rec[b, s, i] > 0 and rec[b, s, j] > 0)
             for b in live for s in range(n_iter)]
    linearized = sum(int(rec[b, s, 1] > 0) for b in live for s in range(n_iter))
    return {"problems_recorded": len(live), "linearized_iterations": linearized,
            "phase_ns_p50_p90": out,
            "chain_ns_min": float(min(chain)), "chain_floor_us": n_iter * float(min(chain)) / 1e3,
            "span_ns": int(max(rec[b].max() for b in live)
                           - min(rec[b][rec[b] > 0].min() for b in live))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--design", choices=sorted(EDITS), default="compact")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import numpy as np
    import torch

    import k4_shapes

    if not torch.cuda.is_available():
        sys.exit("k4_stages: no CUDA device")
    cs = k4_shapes.load("chip_smoke_k4", os.path.join(ROOT, "chip_smoke.py"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    shapes = k4_shapes.capture(cs, ("local-map", "RGB-D", "B = 8 synthetic"))
    k4 = k4_shapes.import_tree(root)
    from orb_slam2_annotate_tpu_torch.kernels import _build

    with open(os.path.join(root, "orb_slam2_annotate_tpu_torch", "csrc", "pose_lm.cu")) as f:
        text = instrumented(f.read(), args.design)
    out_dir = os.path.join(ROOT, "orb_slam2_annotate_tpu_torch", "_build", "k4_stages", args.design)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "pose_lm.cu")
    lib_path = os.path.join(out_dir, "libk4_stages.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.BASE_FLAGS,
                    *_build.SOURCES["pose_lm"], "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    marks = (ctypes.c_longlong * (MB * MI * NM * MW))()
    real_load = _build.load
    for name, a in shapes.items():
        graph = cs.graph_us(lambda: k4.optimize_pose_batched(*a))
        _build.load = lambda n: lib if n == "pose_lm" else real_load(n)
        k4._fn.cache_clear()
        try:
            for _ in range(3):
                k4.optimize_pose_batched(*a)
            torch.cuda.synchronize()
            _build.check_launch(lib.k4_marks_clear(), "k4_marks_clear")
            k4.optimize_pose_batched(*a)
            torch.cuda.synchronize()
            _build.check_launch(lib.k4_marks_read(marks), "k4_marks_read")
        finally:
            _build.load = real_load
            k4._fn.cache_clear()
        m = np.frombuffer(marks, dtype=np.int64).reshape(MB, MI, NM, MW)
        valid, ur = a[7], a[5]
        row = {"shape": name, "design": args.design, "B": int(valid.shape[0]),
               "N": int(valid.shape[1]), "edges": int(valid.sum()),
               "stereo_rows": int(((ur >= 0) & valid).sum()),
               **phase_stats(m, args.design, 4 * 5, 4), "graph_us": graph}
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()
