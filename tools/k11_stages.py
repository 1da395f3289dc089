#!/usr/bin/env python3
"""Kernel 11's device time split by phase, on the card.

    python3 tools/k11_stages.py

Builds a copy of ``csrc/segment_sum.cu`` with nvcc into
``orb_slam2_annotate_tpu_torch/_build/k11_stages/`` (gitignored) in which
the kernels read ``%globaltimer`` at fixed points, each read waiting on a
value loaded just before it; the committed source holds no switch: the copy
is the text with fixed strings replaced, and each replacement must match
exactly once.  The walk records, for lane 0 of each warp: its start, its
offsets, its first eight rows' indices, their values, its store.  The tiles
record, for thread 0 of each CTA's first tile: its start, the zero fill
issued, the offsets landed, the first stages' indices landed, stage 0's rows
landed, the tile's chains done, its last barrier.  On
``tools/k11_shapes.py``'s seven synthetic call shapes, one call after three
warm-up calls, it prints a JSON line a shape: the path, the median and 90th
percentile of each phase (ns) over the warps or CTAs, the span from the
first start to the last end, and the uninstrumented kernel's CUDA-graph
replay time (chip_smoke.graph_us).  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SLOTS = 32768
HEADER = "// UB: bytes a copy (16, 8 or 4, dividing 4 D and vals' address); R rows a stage\n"
MARKS = f"""__device__ long long k11_marks[{SLOTS}][8];
extern "C" int k11_marks_read(long long* host) {{
    return (int)cudaMemcpyFromSymbol(host, k11_marks, sizeof(k11_marks));
}}
extern "C" int k11_marks_clear() {{
    static long long zero[{SLOTS}][8];
    return (int)cudaMemcpyToSymbol(k11_marks, zero, sizeof(zero));
}}
// the time, read once `dep` has landed, into mark i of `slot`
#define MARK(slot, i, dep)                                                       \\
    if ((slot) < {SLOTS}) {{                                                      \\
        unsigned long long t_;                                                  \\
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_) : "r"((int)(dep))); \\
        k11_marks[(slot)][(i)] = (long long)t_;                                 \\
    }}
#define MARK_WALK(i, dep) if ((threadIdx.x & 31) == 0) MARK(q >> 5, i, dep)
#define MARK_TILE(i, dep) if (tid == 0 && t == blockIdx.x) MARK(blockIdx.x, i, dep)
"""
VALUES = ("        for (int k = 0; k < 8; ++k) v[k] = i + k < e ? "
          "vals[(size_t)p[k] * D + c] : 0.f;\n")
NSEG = "        const int nseg = (int)min((long long)G, S - s0);\n"
ZERO = "        zero_fill(out + (size_t)s0 * D, (long long)nseg * D, tid);\n"
INDICES = ("        for (int k = 0; k < NS; ++k) issue_perm(k);\n        cp_commit();\n"
           "        cp_wait<0>();\n        __syncthreads();\n")
ROWS = "        const int r0 = soff[0], r1 = soff[nseg], rows = r1 - r0;\n"
TILE_END = ("        cp_wait<0>();\n        __syncthreads();"
            "                                    // before the next tile's copies\n")
# (old text, new text): each must match once
EDITS = [
    ("// The walk: a thread a (segment, column) chain",
     MARKS + "// The walk: a thread a (segment, column) chain"),
    ("    const int b = offsets[s], e = offsets[s + 1];\n",
     "    MARK_WALK(0, c)\n    const int b = offsets[s], e = offsets[s + 1];\n"
     "    MARK_WALK(1, b + e)\n"),
    ("        for (int k = 0; k < 8; ++k) p[k] = i + k < e ? perm[i + k] : 0;\n",
     "        for (int k = 0; k < 8; ++k) p[k] = i + k < e ? perm[i + k] : 0;\n"
     "        if (i == b) MARK_WALK(2, p[0])\n"),
    (VALUES, VALUES + "        if (i == b) MARK_WALK(3, __float_as_int(v[0]))\n"),
    ("    out[q] = acc;\n}", "    out[q] = acc;\n    MARK_WALK(4, __float_as_int(acc))\n}"),
    (NSEG, NSEG + "        MARK_TILE(0, nseg)\n"),
    (ZERO, ZERO + "        MARK_TILE(1, nseg)\n"),
    (ROWS, ROWS + "        MARK_TILE(2, r1)\n"),
    (INDICES, INDICES + "        MARK_TILE(3, sperm[0])\n"),
    ("            __syncthreads();                                // stage k - 1 is added\n",
     "            __syncthreads();                                // stage k - 1 is added\n"
     "            if (k == 0) MARK_TILE(4, srows[0])\n"),
    (TILE_END, "        MARK_TILE(5, nseg)\n" + TILE_END + "        MARK_TILE(6, nseg)\n"),
]
PHASES = {"walk": ["offsets", "indices", "values", "adds and store"],
          "tiles": ["zero fill issued", "offsets landed", "indices landed", "stage 0 landed",
                    "chains", "last barrier"]}


def instrumented(text: str) -> str:
    assert HEADER in text
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"k11_stages: {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def load(name: str, path: str):
    """The module at `path`, imported as `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    import numpy as np
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import _build
    from orb_slam2_annotate_tpu_torch.kernels import segment_sum as k11

    if not torch.cuda.is_available():
        sys.exit("k11_stages: no CUDA device")
    cs, shapes = (load(name, path) for name, path in (
        ("chip_smoke_k11", os.path.join(ROOT, "chip_smoke.py")),
        ("k11_shapes", os.path.join(ROOT, "tools", "k11_shapes.py"))))
    with open(os.path.join(_build.CSRC_DIR, "segment_sum.cu")) as f:
        text = instrumented(f.read())
    out_dir = os.path.join(_build.BUILD_DIR, "k11_stages")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "segment_sum.cu")
    lib_path = os.path.join(out_dir, "libk11_stages.so")
    with open(src, "w") as f:
        f.write(text)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.BASE_FLAGS,
                    *_build.SOURCES["segment_sum"], "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    launch = lib.segment_sum_launch
    launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    marks = (ctypes.c_longlong * (SLOTS * 8))()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for i, (name, (E, S, D, live, longest)) in enumerate(shapes.SHAPES.items()):
        idx, vals = cs.k11_case(100 + i, E, S, D, live, longest)
        plan = k11.segment_plan(idx, S)
        walk = D <= plan.walk_d
        R = 0 if walk else k11.stage_rows(D, plan.hint)
        out = torch.empty((S, D), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            _build.check_launch(launch(plan._c, vals.data_ptr(), out.data_ptr(), D, R, stream),
                                "k11_stages")
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        _build.check_launch(lib.k11_marks_clear(), "k11_marks_clear")
        call()
        torch.cuda.synchronize()
        _build.check_launch(lib.k11_marks_read(marks), "k11_marks_read")
        m = np.frombuffer(marks, dtype=np.int64).reshape(SLOTS, 8)
        path = "walk" if walk else "tiles"
        n = len(PHASES[path]) + 1
        m = m[(m[:, :n] > 0).all(axis=1), :n]
        d = np.diff(m, axis=1)
        row = {"shape": name, "path": path, "recorded": int(len(m)),
               "phase_ns_p50": dict(zip(PHASES[path], np.median(d, axis=0).round(1).tolist())),
               "phase_ns_p90": dict(zip(PHASES[path],
                                        np.percentile(d, 90, axis=0).round(1).tolist())),
               "span_ns": int(m[:, -1].max() - m[:, 0].min()),
               "graph_us": cs.graph_us(lambda: k11.segment_sum(plan, vals))}
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()
