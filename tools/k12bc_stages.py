#!/usr/bin/env python3
"""Kernels 12b and 12c (the dense BA's Cholesky, the distributed BA's LU)
split into stages on the card.

    python3 tools/k12bc_stages.py [--root DIR] [--n 768]

Builds copies of the tree's ``csrc/chol_solve.cu`` and ``csrc/lu_solve.cu``
(``--root``, default this checkout; the earlier design, with ``chol_tri`` /
``lu_tri``, or the current one, told apart by their kernels' names) with nvcc into
``orb_slam2_annotate_tpu_torch/_build/k12bc_stages/`` (gitignored), with
fixed strings replaced (each must match once; the committed sources hold no
switch): thread 0 of each CTA reads ``%globaltimer`` at its start, after
each stage and at its end, and one thread of the panel's first CTA adds up
``clock64`` cycles a stage over the panel's column steps (converted to ns
by that CTA's own clock over its span).  On a random SPD (12b) and general
(12c) system of size n made from a seed, it runs the copy once after three
warm calls and prints a JSON line a kernel: the launches' summed spans
(first CTA start to last CTA end) and the gaps between them, the critical
CTA's stages summed over the panels (12b: the chains over earlier columns,
the diagonal block, the rows below it, the triangles; 12c: the argmax, the
swap and multipliers, the panel update, the trailing update, the
triangles), the uninstrumented solve's CUDA-graph replay
(``chip_smoke.graph_us``) and its chain floor: the solve's launches, each
at the time of an empty kernel launched back to back, plus the column
steps that cannot overlap, each at its dependent latency probed here (12b:
n x (a square root, a division, a multiply-subtract) for the pivots and n
x (a division, a multiply-subtract) for the back solve; 12c: n x (two
redux.sync, a division, a multiply-subtract) and the same back solve).
Then the card's name and power limit (``nvidia-smi``).  Needs a card and
nvcc.
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

MAXL, MAXB, M = 128, 512, 10     # launches, CTAs a launch, slots a CTA
UPDATE_L = 64                    # the earlier LU: lu_update's records at panel + 64
PRELUDE = f"""
#define K12BC_MAXL {MAXL}
#define K12BC_MAXB {MAXB}
__device__ unsigned long long k12bc_t[K12BC_MAXL][K12BC_MAXB][{M}];
__device__ __forceinline__ unsigned long long k12bc_now() {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}}
// the record a CTA writes: its blockIdx unless a kernel below says otherwise
#define K12BC_B blockIdx.x
#define K12BC_OK(L) ((L) < K12BC_MAXL && (K12BC_B) < K12BC_MAXB)
// csrc's div_rn, for the loops below (the sources define theirs after this prelude)
__device__ __forceinline__ float k12bc_div_rn(float a, float b) {{
    if (a == 0.0f && b != 0.0f && fabsf(b) <= 3.402823466e38f) return a * b;
    return a / b;
}}
// slots 0-4: globaltimer marks; 8 / 9: clock64 at marks 0 / 4; 5-7: cycle sums
#define K12BC_MARK(L, i)                                                          \\
    if (threadIdx.x == 0 && threadIdx.y == 0 && K12BC_OK(L)) {{                   \\
        k12bc_t[(L)][K12BC_B][(i)] = k12bc_now();                                 \\
        if ((i) == 0) k12bc_t[(L)][K12BC_B][8] = clock64();                        \\
        if ((i) == 4) k12bc_t[(L)][K12BC_B][9] = clock64();                        \\
    }}
#define K12BC_SET(L, slot, v) if (K12BC_OK(L)) k12bc_t[(L)][K12BC_B][(slot)] = (v);
extern "C" int k12bc_read(void* host) {{
    return (int)cudaMemcpyFromSymbol(host, k12bc_t, sizeof(k12bc_t));
}}
extern "C" int k12bc_clear() {{
    void* p;
    cudaError_t e = cudaGetSymbolAddress(&p, k12bc_t);
    return e != cudaSuccess ? (int)e : (int)cudaMemset(p, 0, sizeof(k12bc_t));
}}
__global__ void k12bc_empty() {{}}
extern "C" int k12bc_empty_launch(cudaStream_t s) {{
    k12bc_empty<<<1, 32, 0, s>>>();
    return (int)cudaGetLastError();
}}
// dependent latencies (ns an iteration, one warp): [0] sqrtf + division +
// multiply-subtract, [1] division + multiply-subtract, [2] two redux.sync +
// division + multiply-subtract
__global__ void k12bc_probe(float seed, int iters, unsigned long long* out) {{
    float x = seed + threadIdx.x * 1e-7f, y = 1.0001f, z = 0.25f;
    unsigned long long t0 = k12bc_now();
    for (int i = 0; i < iters; ++i) x = sqrtf(x + 2.0f) / y - x * z;
    unsigned long long t1 = k12bc_now();
    for (int i = 0; i < iters; ++i) x = (x + 2.0f) / y - x * z;
    unsigned long long t2 = k12bc_now();
    unsigned long long t2b = k12bc_now();
    for (int i = 0; i < iters; ++i) x = (x - x) / y + x;    // a zero dividend each time
    unsigned long long t2c = k12bc_now();
    for (int i = 0; i < iters; ++i) {{
        const unsigned k = __reduce_max_sync(0xffffffffu, __float_as_uint(x) & 0x7fffffffu);
        const int p = __reduce_min_sync(0xffffffffu, (int)(k & 31) + (int)threadIdx.x);
        x = (x + (float)p) / y - x * z;
    }}
    unsigned long long t3 = k12bc_now();
    if (threadIdx.x == 0) {{
        out[0] = t1 - t0;
        out[1] = t2 - t1;
        out[2] = t3 - t2c;
        out[3] = __float_as_uint(x);
        out[4] = t2c - t2b;
    }}
}}
// the diagonal block's loop (csrc/chol_solve.cu's code) on one warp, `reps` times: MODE 0
// as in the kernel, 1 the terms' factors shuffled (no Dt, no __syncwarp, no publication),
// 2 without the publication (fence, dcol), 3 the pivot chain alone (no terms)
template <int MODE>
__device__ float k12bc_diag(int reps, float (*Dt)[32], volatile int& dcol, float tot) {{
    const int x = threadIdx.x;
    float a[32];
    for (int r = 0; r < reps; ++r) {{
#pragma unroll
        for (int c = 0; c < 32; ++c) a[c] = c == x ? 40.0f + 1e-7f * tot : (c < x ? 0.5f : 0.0f);
        float piv = __shfl_sync(0xffffffffu, a[0], 0);
#pragma unroll
        for (int jj = 0; jj < 32; ++jj) {{
            const float ljj = sqrtf(piv);
            const float q = k12bc_div_rn(a[jj], ljj);
            const float l = x == jj ? ljj : (x > jj ? q : 0.0f);
            a[jj] = l;
            if (jj + 1 < 32) piv = __shfl_sync(0xffffffffu, a[jj + 1] - l * l, jj + 1);
            if (MODE == 3) continue;
            if (MODE == 1) {{
#pragma unroll
                for (int c = jj + 1; c < 32; ++c) a[c] -= l * __shfl_sync(0xffffffffu, l, c);
                continue;
            }}
            Dt[jj][x] = l;
            __syncwarp();
            if (MODE == 0 && (jj & 3) == 3) {{
                __threadfence_block();
                dcol = jj + 1;
            }}
#pragma unroll
            for (int q = (jj + 1) / 4; q < 8; ++q) {{
                const float4 l4 = reinterpret_cast<const float4*>(Dt[jj])[q];
                const float lv[4] = {{l4.x, l4.y, l4.z, l4.w}};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (4 * q + e > jj) a[4 * q + e] -= l * lv[e];
            }}
        }}
        tot += a[31];
    }}
    return tot;
}}
// one warp alone: [0] ns and [1] clock64 cycles of `reps` back-solve blocks (32 steps
// each: a division, a shuffle, a multiply-subtract, csrc's code) and [2] ns and [3]
// cycles of `reps` 32-column diagonal-block factorizations (csrc's code)
__global__ void k12bc_loops(int reps, unsigned long long* out, float* sink) {{
    __shared__ __align__(16) float Dt[32][32];
    __shared__ volatile int dcol;
    const int lane = threadIdx.x;
    float cf[32], dd[32];
    for (int j = 0; j < 32; ++j) {{
        cf[j] = j > lane ? 0.01f * (j - lane) : 0.0f;
        dd[j] = 2.0f + j;
    }}
    float acc = 1.0f + lane, tot = 0.0f;
    unsigned long long t0 = k12bc_now(), c0 = clock64();
    for (int r = 0; r < reps; ++r) {{
#pragma unroll
        for (int jj = 31; jj >= 0; --jj) {{
            const float xj = k12bc_div_rn(__shfl_sync(0xffffffffu, acc, jj), dd[jj]);
            acc = lane == jj ? xj : (lane < jj ? acc - cf[jj] * xj : acc);
        }}
        tot += acc;
        acc = 1.0f + lane + 1e-7f * tot;
    }}
    unsigned long long t1 = k12bc_now(), c1 = clock64();
    tot += k12bc_diag<0>(reps, Dt, dcol, tot);
    unsigned long long t2 = k12bc_now(), c2 = clock64();
    tot += k12bc_diag<1>(reps, Dt, dcol, tot);
    unsigned long long c3 = clock64();
    tot += k12bc_diag<2>(reps, Dt, dcol, tot);
    unsigned long long c4 = clock64();
    tot += k12bc_diag<3>(reps, Dt, dcol, tot);
    unsigned long long c5 = clock64();
    if (lane == 0) {{
        out[0] = t1 - t0;
        out[1] = c1 - c0;
        out[2] = t2 - t1;
        out[3] = c2 - c1;
        out[4] = c3 - c2;
        out[5] = c4 - c3;
        out[6] = c5 - c4;
        *sink = tot;
    }}
}}
extern "C" int k12bc_loops_run(int reps, unsigned long long* host) {{
    unsigned long long* d;
    float* sink;
    if (cudaMalloc(&d, 7 * sizeof(unsigned long long)) != cudaSuccess) return 1;
    if (cudaMalloc(&sink, sizeof(float)) != cudaSuccess) return 1;
    k12bc_loops<<<1, 32>>>(reps, d, sink);
    cudaError_t e = cudaMemcpy(host, d, 7 * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
    cudaFree(d);
    cudaFree(sink);
    return (int)e;
}}
extern "C" int k12bc_probe_run(int iters, unsigned long long* host) {{
    unsigned long long* d;
    if (cudaMalloc(&d, 5 * sizeof(unsigned long long)) != cudaSuccess) return 1;
    k12bc_probe<<<1, 32>>>(1.5f, iters, d);
    cudaError_t e = cudaMemcpy(host, d, 5 * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
    cudaFree(d);
    return (int)e;
}}
"""
INC = "#include <stdint.h>\n"

# (old text, new text) a design; each old text must match once
CHOL_NEW = [
    (INC, INC + PRELUDE),
    ("    const bool panel = blockIdx.x < npanel;\n",
     "    const bool panel = blockIdx.x < npanel;\n    K12BC_MARK(k, 0)\n"),
    ("        dcol = 0;\n    }\n    __syncthreads();\n",
     "        dcol = 0;\n    }\n    __syncthreads();\n    K12BC_MARK(k, 1)\n"),
    ("            if (y < rb && x < cw && i >= j) A[(size_t)i * n + j] = T[y][x];\n        }\n        return;\n",
     "            if (y < rb && x < cw && i >= j) A[(size_t)i * n + j] = T[y][x];\n        }\n"
     "        K12BC_MARK(k, 4)\n        return;\n"),
    ("        tile_terms(D, LD, LD, x, wid, WARPS);\n        __syncthreads();\n    }\n",
     "        tile_terms(D, LD, LD, x, wid, WARPS);\n        __syncthreads();\n    }\n    K12BC_MARK(k, 2)\n"),
    ("        if (x == 0 && bad) s_fail = 1;\n",
     "        if (x == 0 && bad) s_fail = 1;\n        K12BC_MARK(k, 3)\n"),
    ("    if (blockIdx.x == 0 && threadIdx.x == 0 && s_fail) *fail = 1;\n}\n",
     "    if (blockIdx.x == 0 && threadIdx.x == 0 && s_fail) *fail = 1;\n    __syncthreads();\n"
     "    K12BC_MARK(k, 4)\n}\n"),
    ("    const float* y = A + (size_t)n * n;  // row n of the factor\n",
     "    const float* y = A + (size_t)n * n;  // row n of the factor\n    K12BC_MARK(nb, 0)\n"),
    ("    const bool failed = *fail != 0;\n",
     "    K12BC_MARK(nb, 4)\n    const bool failed = *fail != 0;\n"),
]
CHOL_OLD = [
    (INC, INC + PRELUDE),
    ("    const int i = i0 + ty, jd = j0 + ty, j = j0 + tx;   // tile entry (i, j), diagonal one (jd, j)\n",
     "    const int i = i0 + ty, jd = j0 + ty, j = j0 + tx;   // tile entry (i, j), diagonal one (jd, j)\n"
     "    K12BC_MARK(p, 0)\n"),
    ("    T[ty][tx] = acc;\n", "    K12BC_MARK(p, 1)\n    T[ty][tx] = acc;\n"),
    ("    __syncthreads();\n    if (blockIdx.x == 0) {\n        if (jd < n",
     "    __syncthreads();\n    K12BC_MARK(p, 3)\n    if (blockIdx.x == 0) {\n        if (jd < n"),
    ("        L[(size_t)i * n + j] = T[ty][tx];\n    }\n}\n",
     "        L[(size_t)i * n + j] = T[ty][tx];\n    }\n    __syncthreads();\n    K12BC_MARK(p, 4)\n}\n"),
    ("    for (int i = tid; i < n; i += TRI_THREADS) y[i] = r[i];\n",
     "    K12BC_MARK(nb, 0)\n    for (int i = tid; i < n; i += TRI_THREADS) y[i] = r[i];\n"),
    ("    // L^T x = y: blocks from the last", "    K12BC_MARK(nb, 1)\n    // L^T x = y: blocks from the last"),
    ("    const bool failed = *fail != 0;\n", "    K12BC_MARK(nb, 4)\n    const bool failed = *fail != 0;\n"),
]
LU_NEW = [
    (INC, INC + PRELUDE),
    # the launch's roles go by ticket, not blockIdx: the panel's CTAs record at their rank
    # in its cluster, the items from K12BC_MAXB / 2 on
    ("__device__ void lu_panel(", "#undef K12BC_B\n#define K12BC_B rank\n__device__ void lu_panel("),
    ("__device__ void lu_item(",
     "#undef K12BC_B\n#define K12BC_B (K12BC_MAXB / 2 + it)\n__device__ void lu_item("),
    ("__global__ void __launch_bounds__(THREADS, 1) lu_step(",
     "#undef K12BC_B\n#define K12BC_B blockIdx.x\n__global__ void __launch_bounds__(THREADS, 1) lu_step("),
    ("    const bool live = pos < m;\n",
     "    const bool live = pos < m;\n    K12BC_MARK(k, 0)\n"
     "    const bool k12bc_track = rank == 0 && tid == min(m, THREADS) - 1;\n"
     "    unsigned long long k12bc_s = 0, k12bc_u = 0, k12bc_c = 0;\n"),
    ("    float a[PB];\n    int org = pos;\n", "    K12BC_MARK(k, 1)\n    float a[PB];\n    int org = pos;\n"),
    ("#pragma unroll\n    for (int jj = 0; jj < PB; ++jj) {\n        if (jj >= w) break;\n",
     "    __syncthreads();\n    K12BC_MARK(k, 2)\n#pragma unroll\n    for (int jj = 0; jj < PB; ++jj) {\n        if (jj >= w) break;\n"),
    ("        const int par = jj & 1;\n", "        const int par = jj & 1;\n        k12bc_c = clock64();\n"),
    ("        // the swap: row jj takes the pivot row, the pivot's place the old row jj\n",
     "        k12bc_s += clock64() - k12bc_c;\n        k12bc_c = clock64();\n"
     "        // the swap: row jj takes the pivot row, the pivot's place the old row jj\n"),
    ("                    if (4 * q + e > jj) a[4 * q + e] -= l * uv[e];\n            }\n        }\n    }\n",
     "                    if (4 * q + e > jj) a[4 * q + e] -= l * uv[e];\n            }\n        }\n"
     "        k12bc_u += clock64() - k12bc_c;\n    }\n"
     "    __syncthreads();\n    K12BC_MARK(k, 3)\n"
     "    if (k12bc_track) {\n        K12BC_SET(k, 5, k12bc_s)\n        K12BC_SET(k, 6, k12bc_u)\n    }\n"),
    ("            sw[k * MAX_SWAPS + s] = make_int2(j0 + pos, j0 + org);\n        }\n    }\n}\n",
     "            sw[k * MAX_SWAPS + s] = make_int2(j0 + pos, j0 + org);\n        }\n    }\n"
     "    __syncthreads();\n    K12BC_MARK(k, 4)\n}\n"),
    ("    const int c = tid % tw, rstep = THREADS / tw;\n",
     "    const int c = tid % tw, rstep = THREADS / tw;\n    K12BC_MARK(k, 0)\n"),
    ("            if (c < nc) A[(size_t)r * ld + c0 + c] = c0 + c < n ? S[(size_t)r * n + c0 + c] : b[r];\n"
     "        return;\n",
     "            if (c < nc) A[(size_t)r * ld + c0 + c] = c0 + c < n ? S[(size_t)r * n + c0 + c] : b[r];\n"
     "        __syncthreads();\n        K12BC_MARK(k, 4)\n        return;\n"),
    ("    __syncthreads();\n    // U's rows: warp c takes column c0 + c, lane i row j0p + i\n",
     "    __syncthreads();\n    K12BC_MARK(k, 1)\n    // U's rows: warp c takes column c0 + c, lane i row j0p + i\n"),
    ("    __syncthreads();\n    // the rows below: tw threads a row",
     "    __syncthreads();\n    K12BC_MARK(k, 2)\n    // the rows below: tw threads a row"),
    ("    if (it < nk) {                    // the panel of this launch waits for these\n",
     "    __syncthreads();\n    K12BC_MARK(k, 4)\n"
     "    if (it < nk) {                    // the panel of this launch waits for these\n"),
    ("    for (int i = tid; i < nb * PB; i += BACK_THREADS) v[i] = i < n ? A[(size_t)i * ld + n] : 0.0f;\n",
     "    K12BC_MARK(nb, 0)\n    for (int i = tid; i < nb * PB; i += BACK_THREADS) v[i] = i < n ? A[(size_t)i * ld + n] : 0.0f;\n"),
    ("            if (lane < w) v[j0 + lane] = a;\n            __syncwarp();\n        }\n",
     "            if (lane < w) v[j0 + lane] = a;\n            __syncwarp();\n        }\n        K12BC_MARK(nb, 1)\n"),
    ("    __syncthreads();\n    for (int i = tid; i < n; i += BACK_THREADS) x[i] = v[i];\n",
     "    __syncthreads();\n    K12BC_MARK(nb, 4)\n    for (int i = tid; i < n; i += BACK_THREADS) x[i] = v[i];\n"),
]
# warp 0 of the back solve (both kernels): its cycles a part, summed over the blocks
BACK_W0 = [
    ("        for (int b = nb - 1; b >= 0; --b) {\n"
     "            const int b0 = b * PB, wb = min(PB, n - b0), i = b0 + lane, slot = b % RING;\n",
     "        unsigned long long k12bc_w = 0, k12bc_tm = 0, k12bc_s = 0, k12bc_p = 0;\n"
     "        for (int b = nb - 1; b >= 0; --b) {\n"
     "            unsigned long long k12bc_c = clock64();\n"
     "            const int b0 = b * PB, wb = min(PB, n - b0), i = b0 + lane, slot = b % RING;\n"),
    ("            __threadfence_block();\n            // block b's own coefficients (cf), its diagonal (dd: every lane all 32) and\n",
     "            __threadfence_block();\n            k12bc_w += clock64() - k12bc_c;\n            k12bc_c = clock64();\n"
     "            // block b's own coefficients (cf), its diagonal (dd: every lane all 32) and\n"),
    ("            // x_jj = acc_jj / d_jj, every lane dividing lane jj's dividend (one path for\n",
     "            k12bc_tm += clock64() - k12bc_c;\n            k12bc_c = clock64();\n"
     "            // x_jj = acc_jj / d_jj, every lane dividing lane jj's dividend (one path for\n"),
    ("            if (lane < wb) v[i] = acc;\n            __syncwarp();\n",
     "            k12bc_s += clock64() - k12bc_c;\n            k12bc_c = clock64();\n"
     "            if (lane < wb) v[i] = acc;\n            __syncwarp();\n"),
    ("            solved = nb - b;\n        }\n    } else if (wid == 4) {",
     "            solved = nb - b;\n            k12bc_p += clock64() - k12bc_c;\n        }\n"
     "        if (lane == 0) {\n            K12BC_SET(nb, 2, k12bc_w)\n            K12BC_SET(nb, 3, k12bc_tm)\n"
     "            K12BC_SET(nb, 5, k12bc_s)\n            K12BC_SET(nb, 6, k12bc_p)\n        }\n"
     "    } else if (wid == 4) {"),
]
LU_OLD = [
    (INC, INC + PRELUDE),
    ("    const int j0 = p * PB, w = min(PB, n - j0), m = n - j0, ld = PB + 1;\n",
     "    const int j0 = p * PB, w = min(PB, n - j0), m = n - j0, ld = PB + 1;\n    K12BC_MARK(p, 0)\n"
     "    unsigned long long k12bc_a = 0, k12bc_b = 0, k12bc_d = 0, k12bc_c = 0;\n"),
    ("    __syncthreads();\n    for (int jj = 0; jj < w; ++jj) {\n        float bv = 0.0f;\n",
     "    __syncthreads();\n    K12BC_MARK(p, 1)\n    for (int jj = 0; jj < w; ++jj) {\n"
     "        k12bc_c = clock64();\n        float bv = 0.0f;\n"),
    ("        const int pr = s_pr;\n",
     "        const int pr = s_pr;\n        k12bc_a += clock64() - k12bc_c;\n        k12bc_c = clock64();\n"),
    ("P[r * ld + jj] = P[r * ld + jj] / pivot;\n        __syncthreads();\n",
     "P[r * ld + jj] = P[r * ld + jj] / pivot;\n        __syncthreads();\n"
     "        k12bc_b += clock64() - k12bc_c;\n        k12bc_c = clock64();\n"),
    ("                P[r * ld + c] -= P[r * ld + jj] * P[jj * ld + c];\n            }\n        __syncthreads();\n    }\n",
     "                P[r * ld + c] -= P[r * ld + jj] * P[jj * ld + c];\n            }\n        __syncthreads();\n"
     "        k12bc_d += clock64() - k12bc_c;\n    }\n    K12BC_MARK(p, 3)\n"
     "    if (tid == 0) {\n        K12BC_SET(p, 5, k12bc_a)\n        K12BC_SET(p, 6, k12bc_b)\n"
     "        K12BC_SET(p, 7, k12bc_d)\n    }\n"),
    ("        A[(size_t)(j0 + r) * n + j0 + c] = P[r * ld + c];\n    }\n}\n",
     "        A[(size_t)(j0 + r) * n + j0 + c] = P[r * ld + c];\n    }\n    __syncthreads();\n"
     "    K12BC_MARK(p, 4)\n}\n"),
    ("    const int c = tile * PB + tx;\n",
     f"    const int c = tile * PB + tx;\n    K12BC_MARK(p + {UPDATE_L}, 0)\n"),
    ("    if (tile * PB < j0) return;", f"    if (tile * PB < j0) {{\n        K12BC_MARK(p + {UPDATE_L}, 4)\n"
     "        return;\n    }"),
    ("            A[(size_t)i * n + c] = a;\n        }\n        __syncthreads();\n    }\n}\n",
     "            A[(size_t)i * n + c] = a;\n        }\n        __syncthreads();\n    }\n"
     f"    K12BC_MARK(p + {UPDATE_L}, 4)\n}}\n"),
    ("    for (int i = tid; i < n; i += THREADS) y[i] = b[i];\n",
     "    K12BC_MARK(nb, 0)\n    for (int i = tid; i < n; i += THREADS) y[i] = b[i];\n"),
    ("    // U x = y: blocks from the last", "    K12BC_MARK(nb, 1)\n    // U x = y: blocks from the last"),
    ("    for (int i = tid; i < n; i += THREADS) x[i] = y[i];\n",
     "    K12BC_MARK(nb, 4)\n    for (int i = tid; i < n; i += THREADS) x[i] = y[i];\n"),
]


def instrumented(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"k12bc_stages: {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def spans(t, launches):
    """Each launch's (first CTA start, last CTA end) in ns, over its recorded CTAs."""
    out = {}
    for L in launches:
        rec = t[L][t[L][:, 0] > 0]
        if len(rec):
            out[L] = (int(rec[:, 0].min()), int(rec[:, :5].max()))
    return out


def stage_ns(t, L, i, j, b=0):
    return int(t[L][b][j] - t[L][b][i]) if t[L][b][i] and t[L][b][j] else 0


def cycles_ns(t, L, slot, b=0):
    """Slot `slot`'s cycle sum of CTA b in ns, by that CTA's clock over its span."""
    span_ns, span_cy = t[L][b][4] - t[L][b][0], t[L][b][9] - t[L][b][8]
    return float(t[L][b][slot]) * span_ns / span_cy if span_cy else 0.0


def back_parts(t, nb: int) -> dict:
    """The back solve's warp 0, summed over the blocks (us): waiting for its staged
    tiles and the helpers, the next block's terms, the block's 32 steps, publishing."""
    us = lambda v: round(v / 1e3, 2)
    return {"back solve's warp 0: wait, terms, steps, publish":
            [us(cycles_ns(t, nb, slot)) for slot in (2, 3, 5, 6)]}


def summarize(kind: str, old: bool, t, n: int) -> dict:
    nb = -(-n // 32)
    if kind == "lu_solve" and old:
        order = [L for p in range(nb) for L in (p, p + UPDATE_L)] + [nb]
    else:
        order = list(range(nb)) + [nb]
    sp = spans(t, order)
    seq = [L for L in order if L in sp]
    gaps = [sp[b][0] - sp[a][1] for a, b in zip(seq, seq[1:])]
    panels = [L for L in seq if L < nb]
    us = lambda v: round(v / 1e3, 2)
    row = {"launches_recorded": len(seq), "first_start_to_last_end_us": us(sp[seq[-1]][1] - sp[seq[0]][0]),
           "launch_spans_us": us(sum(sp[L][1] - sp[L][0] for L in seq)),
           "gaps_between_launches_us": us(sum(gaps)),
           "back_solve_us": us(sp[nb][1] - sp[nb][0]) if nb in sp else None}
    if kind == "chol_solve":
        if old:
            row["stages_us"] = {
                "chains over earlier columns (CTA 0)": us(sum(stage_ns(t, L, 0, 1) for L in panels)),
                "diagonal block (CTA 0's panel columns)": us(sum(stage_ns(t, L, 1, 3) for L in panels)),
                "rows below it (CTA 1's panel columns)": us(sum(stage_ns(t, L, 1, 3, 1) for L in panels)),
                "writes": us(sum(stage_ns(t, L, 3, 4) for L in panels)),
                "forward triangle": us(stage_ns(t, nb, 0, 1)), "back triangle": us(stage_ns(t, nb, 1, 4))}
        else:
            row["stages_us"] = {
                "loads (panel CTA 0)": us(sum(stage_ns(t, L, 0, 1) for L in panels)),
                "chains over earlier columns: the previous panel's 32 terms on the diagonal block":
                    us(sum(stage_ns(t, L, 1, 2) for L in panels)),
                "diagonal block (one warp)": us(sum(stage_ns(t, L, 2, 3) for L in panels)),
                "rows below it (a thread a row, up to four columns behind) after the diagonal block, and writes":
                    us(sum(stage_ns(t, L, 3, 4) for L in panels)),
                "forward triangle": "inside the panels (row n of the factor)",
                "back triangle (wavefront)": us(stage_ns(t, nb, 0, 4)),
                **back_parts(t, nb)}
    else:
        if old:
            upd = [L + UPDATE_L for L in panels if L + UPDATE_L in sp]
            row["stages_us"] = {
                "argmax (panel CTA)": us(sum(cycles_ns(t, L, 5) for L in panels)),
                "swap and multipliers": us(sum(cycles_ns(t, L, 6) for L in panels)),
                "panel update": us(sum(cycles_ns(t, L, 7) for L in panels)),
                "panel loads and writes": us(sum(stage_ns(t, L, 0, 1) + stage_ns(t, L, 3, 4)
                                                 for L in panels)),
                "trailing update (its launches' spans)": us(sum(sp[L][1] - sp[L][0] for L in upd)),
                "triangles": us(stage_ns(t, nb, 0, 4)),
                "forward triangle": us(stage_ns(t, nb, 0, 1)), "back triangle": us(stage_ns(t, nb, 1, 4))}
        else:
            items = [[b for b in range(1, MAXB) if t[L][b][0] and t[L][b][2]] for L in panels]
            row["stages_us"] = {
                "wait for the block's items (panel CTA 0)": us(sum(stage_ns(t, L, 0, 1) for L in panels)),
                "argmax and its barrier (a column's search)": us(sum(cycles_ns(t, L, 5) for L in panels)),
                "swap, multipliers and panel update (registers)":
                    us(sum(cycles_ns(t, L, 6) for L in panels)),
                "panel loads (to the first column step)": us(sum(stage_ns(t, L, 1, 2) for L in panels)),
                "panel writes and swap list": us(sum(stage_ns(t, L, 3, 4) for L in panels)),
                "column steps' other time (panel CTA 0, 2 -> 3 less the two above)":
                    us(sum(stage_ns(t, L, 2, 3) - cycles_ns(t, L, 5) - cycles_ns(t, L, 6) for L in panels)),
                "trailing update: the slowest item's gather, U rows, rows below":
                    [us(sum(max((stage_ns(t, L, 0, 1, b) for b in bs), default=0) for L, bs in zip(panels, items))),
                     us(sum(max((stage_ns(t, L, 1, 2, b) for b in bs), default=0) for L, bs in zip(panels, items))),
                     us(sum(max((stage_ns(t, L, 2, 4, b) for b in bs), default=0) for L, bs in zip(panels, items)))],
                "forward triangle": "inside the panels (column n), the last panel's in lu_back: "
                                    f"{us(stage_ns(t, nb, 0, 1))}",
                "back triangle (wavefront)": us(stage_ns(t, nb, 1, 4)),
                **back_parts(t, nb)}
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--n", type=int, default=768)
    ap.add_argument("--fixed-from", type=int, default=None,
                    help="cameras (6 rows each) from this one on held by identity, their b 0, "
                         "as the reduced system of a map padded to n / 6 cameras has them")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import numpy as np
    import torch

    import k4_shapes

    if not torch.cuda.is_available():
        sys.exit("k12bc_stages: no CUDA device")
    cs = k4_shapes.load("chip_smoke_k12bc", os.path.join(ROOT, "chip_smoke.py"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    k4_shapes.import_tree(root)
    from orb_slam2_annotate_tpu_torch.kernels import _build
    from orb_slam2_annotate_tpu_torch.kernels import chol_solve as k12b
    from orb_slam2_annotate_tpu_torch.kernels import lu_solve as k12c

    dev = torch.device("cuda:0")
    out_dir = os.path.join(ROOT, "orb_slam2_annotate_tpu_torch", "_build", "k12bc_stages")
    os.makedirs(out_dir, exist_ok=True)
    real_load = _build.load
    n = args.n
    probe = None
    for kind, mod in (("chol_solve", k12b), ("lu_solve", k12c)):
        with open(os.path.join(root, "orb_slam2_annotate_tpu_torch", "csrc", f"{kind}.cu")) as f:
            text = f.read()
        old = ("chol_tri" if kind == "chol_solve" else "lu_tri") in text
        edits = {("chol_solve", False): CHOL_NEW + BACK_W0, ("chol_solve", True): CHOL_OLD,
                 ("lu_solve", False): LU_NEW + BACK_W0, ("lu_solve", True): LU_OLD}[kind, old]
        src = os.path.join(out_dir, f"{kind}_{'old' if old else 'new'}.cu")
        lib_path = os.path.join(out_dir, f"lib{kind}_{'old' if old else 'new'}.so")
        with open(src, "w") as f:
            f.write(instrumented(text, edits))
        subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, *_build.BASE_FLAGS,
                        *_build.SOURCES[kind], "-o", lib_path, src], check=True)
        lib = ctypes.CDLL(lib_path)
        lib.k12bc_read.argtypes = [ctypes.c_void_p]
        lib.k12bc_empty_launch.argtypes = [ctypes.c_void_p]
        lib.k12bc_probe_run.argtypes = [ctypes.c_int, ctypes.c_void_p]
        if probe is None:
            iters = 20000
            host = (ctypes.c_ulonglong * 5)()
            _build.check_launch(lib.k12bc_probe_run(iters, host), "k12bc_probe")
            lib.k12bc_loops_run.argtypes = [ctypes.c_int, ctypes.c_void_p]
            loops = (ctypes.c_ulonglong * 7)()
            _build.check_launch(lib.k12bc_loops_run(200, loops), "k12bc_loops")
            probe = {"sqrt_div_mulsub_ns": host[0] / iters, "div_mulsub_ns": host[1] / iters,
                     "two_redux_div_mulsub_ns": host[2] / iters,
                     "zero_dividend_div_add_ns": host[4] / iters,
                     "back_solve_step_alone_ns": loops[0] / (200 * 32),
                     "back_solve_step_alone_cycles": loops[1] / (200 * 32),
                     "diagonal_step_alone_ns": loops[2] / (200 * 32),
                     "diagonal_step_alone_cycles": loops[3] / (200 * 32),
                     "diagonal_step_variants_cycles": {
                         "terms' factors shuffled": loops[4] / (200 * 32),
                         "no publication": loops[5] / (200 * 32),
                         "pivot chain alone": loops[6] / (200 * 32)},
                     "sm_clock_ghz": loops[1] / loops[0],
                     "empty_launch_us": 1e3 * cs.time_ms(lambda: lib.k12bc_empty_launch(
                         _build.stream_ptr(dev)), 1000)}
        Sn, rn = cs.dense_random_system(n, 20 + n, kind == "chol_solve")
        if args.fixed_from is not None:
            f0 = 6 * args.fixed_from
            Sn[f0:, :], Sn[:, f0:], rn[f0:] = 0.0, 0.0, 0.0
            Sn[f0:, f0:] = np.eye(n - f0, dtype=np.float32)
        S, r = (torch.from_numpy(a).to(dev) for a in (Sn, rn))
        solve = getattr(mod, kind)
        graph = cs.graph_us(lambda: solve(S, r))
        _build.load = lambda name, lib=lib, kind=kind: lib if name == kind else real_load(name)
        mod._lib.cache_clear()
        try:
            for _ in range(3):
                solve(S, r)
            torch.cuda.synchronize()
            _build.check_launch(lib.k12bc_clear(), "k12bc_clear")
            x = solve(S, r)
            torch.cuda.synchronize()
            host = np.zeros((MAXL, MAXB, M), dtype=np.uint64)
            _build.check_launch(lib.k12bc_read(host.ctypes.data), "k12bc_read")
        finally:
            _build.load = real_load
            mod._lib.cache_clear()
        want = solve(S, r)
        t = host.astype(np.int64)
        row = {"kernel": kind, "design": "earlier" if old else "current", "n": n,
               "cameras_fixed_from": args.fixed_from,
               "instrumented_equals_kernel": bool(torch.equal(x.view(torch.int32), want.view(torch.int32))),
               **summarize(kind, old, t, n), "graph_us": graph,
               "launches_per_solve": mod.launches_per_solve(n) if not old else None}
        per_col = probe["sqrt_div_mulsub_ns"] if kind == "chol_solve" else probe["two_redux_div_mulsub_ns"]
        launches = row["launches_recorded"]
        row["chain_floor_us"] = round(launches * probe["empty_launch_us"]
                                      + n * (per_col + probe["div_mulsub_ns"]) / 1e3, 2)
        row["probe"] = probe
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card}))


if __name__ == "__main__":
    main()
