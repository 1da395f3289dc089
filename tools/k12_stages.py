#!/usr/bin/env python3
"""Kernel 12's device time split by launch and phase, and its bits against
another tree's kernel, on the card.

    python3 tools/k12_stages.py [--root DIR] [--no-slice]
    python3 tools/k12_stages.py --against DIR [--root DIR] [--no-slice]

Split (the default): builds a copy of the tree's ``csrc/grid_ba.cu``
(``--root``, default this checkout; either design: the 32-column panels
with their own step launch, or the first design's 16-column blocks) with
nvcc into ``orb_slam2_annotate_tpu_torch/_build/k12_stages/`` (gitignored),
with fixed strings replaced (each must match once; the committed source
holds no switch): the launcher records a CUDA event before the first launch
and after each launch, after a spinning kernel that holds the stream until
every launch of the solve is queued (so no gap of the host's shows between
them); and ``gba_chol`` reads ``%globaltimer`` in thread 0 of each CTA at
its start, after the assembly, the factorization (with the forward solve),
the back solve (the first design: the two triangular solves), and at its
end, each read waiting on a value produced just before it (the last
iteration's three CTAs are kept).  On the synthetic full-width problem of
``tests/_grid_ba_cases.py`` (C 32, N 1,024, P 2,048) and, unless
``--no-slice``, on the first 4- and 6-iteration local-BA solves from the
second half of ``chip_smoke.py``'s mono slice (phase 4's capture), it
prints a JSON line a problem and iteration count: each launch kind's
median and largest time (us) over the iterations, the solve's span from
the first event to the last, the Cholesky's phases (us, the slowest CTA),
the uninstrumented solve's CUDA-graph replay (``chip_smoke.graph_us``), its
bound (``chip_smoke.grid_ba_work``), its chain floor (the solve's dependent
launches, each at the time of an empty kernel launched back to back, probed
here), and the library's Cholesky on the same three systems in a graph
replay (``torch.linalg.cholesky_ex`` then ``torch.cholesky_solve``: two
calls on the 3 x M x M batch the kernel factors, identity rows and padding
included).

Against (``--against DIR``, e.g. the parent commit unpacked with ``git
archive``): builds DIR's ``grid_ba.cu`` and the tree's, unmodified, into
``_build/k12_against/`` and runs both through the tree's wrapper on the
same inputs: the synthetic full-width case, C 5, 11 and 16 cases, phase 3's
synthetic cases (``problem_cases``), one with a pixel at 3e38 and
robust=False (a right-hand side that is not finite) and the slice's
captured 4- and 6-iteration solves, each for one iteration and for its own
count.  For each
it prints whether R, t, X, the inlier mask, the cost and the workspace's S
(the free camera pairs c >= d), rhs (the free cameras) and dc are equal bit
for bit, then each tree's graph-replay time (DIR, tree, tree, DIR) of the
full-width and slice solves.  Exits 1 if any part differs.  Needs a card
and nvcc; the card's name and power limit come last.
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

MAX_EV = 64          # events of one solve: 2 + 5 x iters launches + 1
CHOL_MARKS = 5       # start, assembled, factored, back-solved, end
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
ENUM = "enum Mode { SETUP = 0, LIN = 1, TRIES = 2, FINAL = 3 };"
SETUP_LAUNCH = "    gba_grid<<<C + 1, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, SETUP, lam0);\n"
LAUNCH_EDITS = [
    (ENUM, TIMING + ENUM),
    (SETUP_LAUNCH, "    k12_nev = 0;\n    k12_spin<<<1, 1, 0, stream>>>(2000000);\n    k12_record(stream);\n"
     + SETUP_LAUNCH + "    k12_record(stream);\n"),
    ("            cm, pb, wk, o, LIN, lam0);\n        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;\n",
     "            cm, pb, wk, o, LIN, lam0);\n        k12_record(stream);\n"
     "        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;\n"),
    ("        gba_grid<<<3 * C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, TRIES, lam0);\n",
     "        gba_grid<<<3 * C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, TRIES, lam0);\n"
     "        k12_record(stream);\n"),
    ("    gba_grid<<<C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, FINAL, lam0);\n",
     "    gba_grid<<<C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, FINAL, lam0);\n"
     "    k12_record(stream);\n"),
]
# the 32-column design's finer parts: gba_chol's warp 0 (its waits for a block, its
# work), workers (each panel's rows below, the next diagonal block's terms, the rest),
# each gba_schur CTA's phases (its start, list built, BH staged, its last warp's end)
PARTS = """
__device__ unsigned long long k12_part[3][6];
__device__ unsigned long long k12_schur[3 * 8 * 32][4];
#define K12_NOW(v) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v))
#define K12_SLOT ((blockIdx.z * 3 + blockIdx.y) * 32 + blockIdx.x)
extern "C" int k12_parts_read(unsigned long long* chol, unsigned long long* schur) {
    cudaError_t e = cudaMemcpyFromSymbol(chol, k12_part, sizeof(k12_part));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemcpyFromSymbol(schur, k12_schur, sizeof(k12_schur));
}
extern "C" int k12_parts_zero() {
    static unsigned long long z[3 * 8 * 32 * 4] = {0};
    cudaError_t e = cudaMemcpyToSymbol(k12_part, z, sizeof(k12_part));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemcpyToSymbol(k12_schur, z, sizeof(k12_schur));
}
"""
SMARK = "if (threadIdx.x == 0) {{ unsigned long long t_; K12_NOW(t_); k12_schur[K12_SLOT][{}] = t_; }}"
PART_EDITS = [
    (ENUM, PARTS + ENUM),
    ("            bool bad = false;\n            for (int p = 0; p < npan; ++p) {\n",
     "            bool bad = false;\n            unsigned long long k12_dwait = 0, k12_d0, k12_t0, k12_t1;\n"
     "            K12_NOW(k12_d0);\n            for (int p = 0; p < npan; ++p) {\n"),
    ("                spin_until(&dready, p);\n                __threadfence_block();\n                float a[PW];",
     "                K12_NOW(k12_t0);\n                spin_until(&dready, p);\n"
     "                __threadfence_block();\n                K12_NOW(k12_t1);\n"
     "                k12_dwait += k12_t1 - k12_t0;\n                float a[PW];"),
    ("            if (lane == 0 && bad) s_fail = 1;\n",
     "            if (lane == 0 && bad) s_fail = 1;\n            if (lane == 0) {\n                K12_NOW(k12_t1);\n"
     "                k12_part[blockIdx.x][0] = k12_dwait;\n"
     "                k12_part[blockIdx.x][1] = k12_t1 - k12_d0 - k12_dwait;\n            }\n"),
    ("            const bool rows = wt < CHOL_WORKERS / 2;\n",
     "            const bool rows = wt < CHOL_WORKERS / 2;\n"
     "            unsigned long long k12_r = 0, k12_ud = 0, k12_us = 0, k12_a, k12_b;\n"
     "            K12_NOW(k12_a);\n"),
    ("                workers_sync();\n                if (t0 >= M) break;\n",
     "                K12_NOW(k12_b);\n                k12_r += k12_b - k12_a;\n                workers_sync();\n"
     "                K12_NOW(k12_a);\n                if (t0 >= M) break;\n"),
    ("                workers_sync();\n                if (wt == 0) {\n                    __threadfence_block();\n",
     "                workers_sync();\n                K12_NOW(k12_b);\n                k12_ud += k12_b - k12_a;\n"
     "                k12_a = k12_b;\n                if (wt == 0) {\n                    __threadfence_block();\n"),
    ("t0 + 4 * (dB + t / dB), t0 + 4 * (t % dB));\n                workers_sync();\n",
     "t0 + 4 * (dB + t / dB), t0 + 4 * (t % dB));\n                workers_sync();\n"
     "                K12_NOW(k12_b);\n                k12_us += k12_b - k12_a;\n                k12_a = k12_b;\n"),
    ("            }\n        }\n        __syncthreads();\n        // the compact forward solve",
     "            }\n            if (wt == 0 || wt == CHOL_WORKERS / 2) {\n"
     "                k12_part[blockIdx.x][wt == 0 ? 2 : 3] = k12_r;\n"
     "                if (wt == 0) {\n                    k12_part[blockIdx.x][4] = k12_ud;\n"
     "                    k12_part[blockIdx.x][5] = k12_us;\n                }\n            }\n"
     "        }\n        __syncthreads();\n        // the compact forward solve"),
    ("    __shared__ int wcnt[NW];\n", "    __shared__ int wcnt[NW];\n    " + SMARK.format(0) + "\n"),
    ("    __syncthreads();\n    const float* Bc = wk.B + (size_t)c * 18 * P;",
     "    __syncthreads();\n    " + SMARK.format(1) + "\n    const float* Bc = wk.B + (size_t)c * 18 * P;"),
    ("    __syncthreads();\n\n    // warp w: d = d0 + w",
     "    __syncthreads();\n    " + SMARK.format(2) + "\n\n    // warp w: d = d0 + w"),
    ("            for (int i = 0; i < 6; ++i) r[i] = -wk.gc[6 * c + i] + racc[i];\n"
     "        }\n    }\n}",
     "            for (int i = 0; i < 6; ++i) r[i] = -wk.gc[6 * c + i] + racc[i];\n"
     "        }\n    }\n    if (lane == 0) {\n        unsigned long long t_;\n        K12_NOW(t_);\n"
     "        atomicMax(&k12_schur[K12_SLOT][3], t_);\n    }\n}"),
]
# the 32-column design (gba_chol, then gba_step): (old text, new text), each must match once
EDITS = LAUNCH_EDITS + [
    ("        for (int i = tid; i < 2 * PW * pts; i += CHOL_THREADS) Pt[i] = 0.0f;\n",
     "        K12_MARK(0, s_fail)\n        for (int i = tid; i < 2 * PW * pts; i += CHOL_THREADS) Pt[i] = 0.0f;\n"),
    ("        const int npan = (M + PW - 1) / PW;\n",
     f"        K12_MARK(1, {F}(A[M * lda]))\n        const int npan = (M + PW - 1) / PW;\n"),
    ("    // L^T x = y over the Mf rows",
     f"    K12_MARK(2, {F}(A[M * lda]))\n    // L^T x = y over the Mf rows"),
    ("    // the step: NaN where the factorization failed, 0 on the cameras not free\n",
     f"    K12_MARK(3, {F}(xs[0]))\n"
     "    // the step: NaN where the factorization failed, 0 on the cameras not free\n"),
    ("    if (tid == 0) wk.fail[k] = failed ? 1 : 0;\n}",
     "    if (tid == 0) wk.fail[k] = failed ? 1 : 0;\n    __syncthreads();\n    K12_MARK(4, failed)\n}"),
    ("            pb, wk, cap);\n", "            pb, wk, cap);\n        k12_record(stream);\n"),
    ("        gba_chol<<<3, CHOL_THREADS, csmem, stream>>>(pb, wk);\n",
     "        gba_chol<<<3, CHOL_THREADS, csmem, stream>>>(pb, wk);\n        k12_record(stream);\n"),
    ("            pb, wk, o);\n        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;\n"
     "        gba_grid<<<3 * C",
     "            pb, wk, o);\n        k12_record(stream);\n"
     "        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;\n        gba_grid<<<3 * C"),
]
EDITS = EDITS[:1] + PART_EDITS + EDITS[1:]
KINDS = ("linearize", "Schur", "Cholesky", "step", "tries")
CHOL_PHASES = {"assembly": (0, 1), "factorization with the forward solve": (1, 2),
               "back solve": (2, 3), "step out": (3, 4), "whole CTA": (0, 4)}
# the first design (16-column blocks; the retraction and the points' steps in gba_chol)
EDITS_FIRST = LAUNCH_EDITS + [
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
    ("        gba_schur<<<dim3(C, 3), SCHUR_THREADS, schur_smem, stream>>>(pb, wk, cap);\n",
     "        gba_schur<<<dim3(C, 3), SCHUR_THREADS, schur_smem, stream>>>(pb, wk, cap);\n"
     "        k12_record(stream);\n"),
    ("        gba_chol<<<3, CHOL_THREADS, csmem, stream>>>(pb, wk, o);\n",
     "        gba_chol<<<3, CHOL_THREADS, csmem, stream>>>(pb, wk, o);\n        k12_record(stream);\n"),
]
KINDS_FIRST = ("linearize", "Schur", "Cholesky", "tries")
CHOL_PHASES_FIRST = {"assembly": (0, 1), "factorization": (1, 2), "triangular solves": (2, 3),
                     "retraction + points' steps": (3, 4), "whole CTA": (0, 4)}


def design(text: str):
    """(edits, launch kinds an iteration, Cholesky phases) of this source's design."""
    if "gba_step" in text:
        return EDITS, KINDS, CHOL_PHASES
    return EDITS_FIRST, KINDS_FIRST, CHOL_PHASES_FIRST


def instrumented(text: str) -> str:
    for old, new in design(text)[0]:
        if text.count(old) != 1:
            raise RuntimeError(f"k12_stages: {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def split(ms: list, iters: int, kinds) -> dict:
    """Each launch kind's median and largest time (us) from the per-launch
    event times of one solve: setup, iters x (the kinds), the mask."""
    us = [1e3 * x for x in ms]
    K = len(kinds)
    out = {"setup": [us[0], us[0]]}
    for j, kind in enumerate(kinds):
        vals = [us[1 + K * i + j] for i in range(iters)]
        out[kind] = [statistics.median(vals), max(vals)]
    out["mask"] = [us[1 + K * iters], us[1 + K * iters]]
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


def build(src: str, out_dir: str, name: str) -> ctypes.CDLL:
    """`src` (a grid_ba.cu text) built with grid_ba's flags into out_dir."""
    from orb_slam2_annotate_tpu_torch.kernels import _build

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.cu")
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    with open(path, "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.BASE_FLAGS,
                    *_build.SOURCES["grid_ba"], "-o", lib_path, path], check=True)
    return ctypes.CDLL(lib_path)


class use_lib:
    """Within the block, the wrapper (kernels/grid_ba.py) launches `lib`."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from orb_slam2_annotate_tpu_torch.kernels import _build
        from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12

        self.real = _build.load
        _build.load = lambda n: self.lib if n == "grid_ba" else self.real(n)
        k12._lib.cache_clear()

    def __exit__(self, *exc):
        from orb_slam2_annotate_tpu_torch.kernels import _build
        from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12

        _build.load = self.real
        k12._lib.cache_clear()


def library_cholesky_us(cs, cam, g):
    """The library's Cholesky on the three systems the kernel factors in a
    1-iteration solve (assembled as gba_chol does: the free cameras' blocks,
    identity rows and padding to a multiple of 16): {"graph_us": ..} in a graph
    replay, or the 100-call time where the library cannot be captured."""
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12

    C, P = g.pt_loc.shape[0], g.points.shape[0]
    dev = g.points.device
    work = torch.empty(k12.work_bytes(C, P), dtype=torch.uint8, device=dev)
    k12.grid_ba_solve(cam, g, 1, work=work)
    v = k12.work_views(work, C, P)
    n, M = 6 * C, (6 * C + 15) // 16 * 16
    free = g.cam_valid & ~g.cam_fixed
    pair = free[:, None] & free[None, :] & torch.ones(C, C, dtype=torch.bool, device=dev).tril()
    blocks = torch.where(pair[None, :, :, None], v["S"].reshape(3, C, C, 36), 0.0)
    low = blocks.reshape(3, C, C, 6, 6).permute(0, 1, 3, 2, 4).reshape(3, n, n).tril()
    Sf = torch.eye(M, device=dev).repeat(3, 1, 1)
    f6 = free.repeat_interleave(6)
    Sn = low + low.transpose(1, 2) - torch.diag_embed(torch.diagonal(low, dim1=1, dim2=2))
    Sf[:, :n, :n] = torch.where((f6[:, None] & f6[None, :])[None], Sn, torch.eye(n, device=dev))
    r = torch.zeros(3, M, 1, device=dev)
    r[:, :n, 0] = torch.where(free[None, :, None], v["rhs"], 0.0).reshape(3, n)
    fn = lambda: torch.cholesky_solve(r, torch.linalg.cholesky_ex(Sf)[0])
    # cuSOLVER's batched solves (MAGMA's allocate while a graph captures)
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return {"graph_us": cs.graph_us(fn)}
    except RuntimeError as e:
        torch.cuda.synchronize()
        return {"us_100_calls": 1e3 * cs.time_ms(fn), "graph_capture_failed": str(e)[:120]}
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def bits(a, b) -> bool:
    """Equal bit for bit (float tensors by their bits, so NaN patterns too)."""
    import torch

    if a.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def solve_parts(cam, g, iters, robust, lam0, ladder):
    """A solve's outputs and workspace parts, on a fresh workspace."""
    import torch

    from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12

    C, P = g.pt_loc.shape[0], g.points.shape[0]
    dev = g.points.device
    work = torch.zeros(k12.work_bytes(C, P), dtype=torch.uint8, device=dev)
    R, t, X, inl, cost = k12.grid_ba_solve(cam, g, iters, robust, lam0, ladder, work=work)
    torch.cuda.synchronize()
    v = k12.work_views(work, C, P)
    free = g.cam_valid & ~g.cam_fixed
    pair = free[:, None] & free[None, :] & torch.ones(C, C, dtype=torch.bool, device=dev).tril()
    return {"R": R, "t": t, "X": X, "inlier": inl, "cost": cost,
            "S": v["S"][:, pair].clone(), "rhs": v["rhs"][:, free].clone(), "dc": v["dc"].clone()}


def against(cs, args, card):
    import numpy as np
    import torch

    from orb_slam2_annotate_tpu_torch.geometry.camera import CameraModel
    from orb_slam2_annotate_tpu_torch.kernels import grid_ba as k12

    dev = torch.device("cuda:0")
    out_dir = os.path.join(ROOT, "orb_slam2_annotate_tpu_torch", "_build", "k12_against")
    libs = {}
    for side, root in (("against", os.path.abspath(args.against)), ("tree", os.path.abspath(args.root))):
        with open(os.path.join(root, "orb_slam2_annotate_tpu_torch", "csrc", "grid_ba.cu")) as f:
            libs[side] = build(f.read(), out_dir, f"grid_ba_{side}")
    cases = cs.grid_ba_cases()
    cam = CameraModel.create(**cases["CAM"])
    ladder = (1.0, 8.0, 64.0)
    probs = {}
    for C, seed in ((32, 12), (5, 13), (11, 14), (16, 15)):
        probs[f"synthetic C {C}, N 1024, P 2048"] = (
            cam, cs.grid_on(cases["grid_problem"](seed, C, 1024, 2048), dev), 6 if C == 32 else 4,
            True, 1e-5, ladder)
    for name, (p, iters, robust, lam0, lad) in cases["problem_cases"](*cs.GBA_CASE_SIZE, 12).items():
        probs[f"phase 3: {name}"] = (cam, cs.grid_on(p, dev), iters, robust, lam0, lad)
    # a right-hand side that is not finite: one free camera's pixel at 3e38, robust=False
    p = cases["grid_problem"](16, *cs.GBA_CASE_SIZE)
    slot = int(np.nonzero(p["edge_valid"][0])[0][0])
    p["uv"][0, slot] = 3e38
    probs["a pixel at 3e38, robust=False (an infinite right-hand side)"] = (
        cam, cs.grid_on(p, dev), 2, False, 1e-5, ladder)
    if not args.no_slice:
        with use_lib(libs["tree"]):
            for iters, (c_, g) in slice_problems(cs).items():
                probs[f"slice ({iters}-iteration solve)"] = (c_, g, iters, True, 1e-5, ladder)
    all_equal = True
    for name, (c_, g, iters, robust, lam0, lad) in probs.items():
        for it in sorted({1, iters, 4} if name.startswith("synthetic C 32") else {1, iters}):
            parts = {}
            for side, lib in libs.items():
                with use_lib(lib):
                    parts[side] = solve_parts(c_, g, it, robust, lam0, lad)
            eq = {k: bits(parts["against"][k], parts["tree"][k]) for k in parts["tree"]}
            all_equal &= all(eq.values())
            print(json.dumps({"case": name, "iters": it, "C": int(g.pt_loc.shape[0]),
                              "equal": eq, "all_equal": all(eq.values())}), flush=True)
    times = {}
    for name, (c_, g, iters, robust, lam0, lad) in probs.items():
        if not (name.startswith("synthetic C 32") or name.startswith("slice")):
            continue
        us = {"against": [], "tree": []}
        for side in ("against", "tree", "tree", "against"):
            with use_lib(libs[side]):
                us[side].append(cs.graph_us(lambda: k12.grid_ba_solve(c_, g, iters, robust, lam0, lad)))
        times[f"{name}, {iters} iterations"] = us
    print(json.dumps({"graph_us (against, tree; in turns against, tree, tree, against)": times}))
    print(json.dumps({"all_equal": all_equal, "against": os.path.abspath(args.against),
                      "tree": os.path.abspath(args.root), "card": card}))
    if not all_equal:
        sys.exit(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--no-slice", action="store_true")
    ap.add_argument("--against", default=None)
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
    if args.against:
        against(cs, args, card)
        return
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
        text = f.read()
    _, kinds, phases = design(text)
    parts = "gba_step" in text       # the 32-column design's finer parts
    lib = build(instrumented(text), os.path.join(ROOT, "orb_slam2_annotate_tpu_torch", "_build",
                                                 "k12_stages"), "k12_stages")
    if parts:
        lib.k12_parts_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        chol_parts = (ctypes.c_ulonglong * 18)()
        schur_parts = (ctypes.c_ulonglong * (3 * 8 * 32 * 4))()
    lib.k12_events_read.argtypes = [ctypes.c_void_p]
    lib.k12_chol_read.argtypes = [ctypes.c_void_p]
    lib.k12_empty_launch.argtypes = [ctypes.c_void_p]
    _build.check_launch(lib.k12_events_init(), "k12_events_init")
    # the launch floor: an empty kernel launched back to back
    stream = _build.stream_ptr(dev)
    floor_ms = cs.time_ms(lambda: lib.k12_empty_launch(stream), 1000)
    ms = (ctypes.c_float * MAX_EV)()
    chol = (ctypes.c_longlong * (3 * CHOL_MARKS))()
    per_iter = len(kinds)
    for name, (cam, g) in problems.items():
        lib_chol_us = library_cholesky_us(cs, cam, g)
        for iters in ((4, 6) if name == "synthetic" else (int(name.split("(")[1][0]),)):
            graph = cs.graph_us(lambda: k12.grid_ba_solve(cam, g, iters))
            nb, ops = cs.grid_ba_work(g, iters)
            bound_ms, bound_by = cs.bound(nb, ops)
            with use_lib(lib):
                if parts:
                    _build.check_launch(lib.k12_parts_zero(), "k12_parts_zero")
                for _ in range(3):
                    k12.grid_ba_solve(cam, g, iters)
                torch.cuda.synchronize()
                k12.grid_ba_solve(cam, g, iters)
                n_ev = lib.k12_events_read(ms)
                _build.check_launch(lib.k12_chol_read(chol), "k12_chol_read")
                if parts:
                    _build.check_launch(lib.k12_parts_read(chol_parts, schur_parts), "k12_parts_read")
            per = list(ms[:n_ev - 1])
            m = np.frombuffer(chol, dtype=np.int64).reshape(3, CHOL_MARKS)
            chol_us = {k: float((m[:, j] - m[:, i]).max()) / 1e3 for k, (i, j) in phases.items()}
            sp = split(per, iters, kinds)
            launches = 2 + per_iter * iters
            row = {"problem": name, "iters": iters, "C": int(g.pt_loc.shape[0]),
                   "N": int(g.pt_loc.shape[1]), "P": int(g.points.shape[0]),
                   "launches": launches, "launch_us_median_max": sp, "span_us": 1e3 * sum(per),
                   "cholesky_us_last_iteration": chol_us, "graph_us": graph,
                   "library_cholesky": lib_chol_us,
                   "bound_ms": bound_ms, "bound_by": bound_by, "empty_launch_us": 1e3 * floor_ms,
                   "chain_floor_us": 1e3 * floor_ms * launches}
            if parts:
                row["cholesky_parts_us"] = part_split(np.frombuffer(chol_parts, dtype=np.uint64))
                row["schur_phases_us"] = schur_split(np.frombuffer(schur_parts, dtype=np.uint64))
            print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))


def part_split(a) -> dict:
    """gba_chol's parts (us summed over the panels, the slowest of the three
    CTAs; the last iteration): warp 0 waiting for each diagonal block and
    factoring them; a row warp's rows below and a far warp's far part (each to
    the barrier after them), then the workers' terms on the next diagonal block
    and on the strip below it, each with its barrier."""
    a = a.reshape(3, 6).astype(float) / 1e3
    names = ("warp 0 waits", "warp 0 diagonal blocks", "row warps: rows below",
             "far warps: the previous panel's far part", "workers: the next diagonal block",
             "workers: the strip below it")
    return {n: float(a[:, j].max()) for j, n in enumerate(names)}


def schur_split(a) -> dict:
    """gba_schur's phases over the CTAs that worked in the last iteration (us):
    the largest time of each (list, BH, the warps' sums with the write), the
    largest CTA, the spread of the CTAs' starts and the launch's span from the
    first start to the last end; the slowest CTA as (c, k, group)."""
    import numpy as np

    a = a.reshape(3 * 8 * 32, 4).astype(np.int64)
    ok = (a > 0).all(1) & (a[:, 3] >= a[:, 2]) & (a[:, 2] >= a[:, 1]) & (a[:, 1] >= a[:, 0])
    if not ok.any():
        return {}
    w = a[ok].astype(float) / 1e3
    slow = int(np.nonzero(ok)[0][np.argmax(w[:, 3] - w[:, 0])])
    return {"ctas": int(ok.sum()), "list": float((w[:, 1] - w[:, 0]).max()),
            "BH": float((w[:, 2] - w[:, 1]).max()), "sums": float((w[:, 3] - w[:, 2]).max()),
            "cta": float((w[:, 3] - w[:, 0]).max()), "starts_spread": float(w[:, 0].max() - w[:, 0].min()),
            "span": float(w[:, 3].max() - w[:, 0].min()),
            "slowest_c_k_group": [slow % 32, (slow // 32) % 3, slow // 96]}


if __name__ == "__main__":
    main()
