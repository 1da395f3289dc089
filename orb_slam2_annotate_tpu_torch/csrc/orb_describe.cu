// Kernel 2: a frame's keypoint selection, IC orientation and steered BRIEF,
// every pyramid level, from kernel 1's [L,H0,W0] stacks to the frame's
// features, in two launches.
//
// Replaces (JAX reference): ops/select.py select_keypoints (per-cell argmax
// :53, lax.top_k :59) for every level, ops/orb.py keypoint_patches,
// ic_angles_patches and brief_descriptors_patches (:256, :278, :297), and
// the scale to level 0 and the pad of ops/extractor.py (:55, :76, :101).
// The reference evaluates the 512 bits as a [N,1369]x[32,1369,512] +-1
// matmul (a TPU matrix-unit device); each bit is exactly the direct compare
// p < q, which this kernel does.
//
// Bound: bytes.  Selection reads every level pixel's score and is_hi (5 B,
// ~0.95 M level pixels at VGA x 8 levels); describing reads a 31x31 patch and
// 1024 blurred samples a keypoint (~8 KB, 1024 keypoints).  Both are a few
// microseconds at 3.35 TB/s, so the design aims at few launches, no block
// barriers and no host work between the stages.
//
// Both stages give each cell of every level one warp, 8 cells a CTA, all of
// one level (Level.cta_base says which).
// Stage A (select_cells): prio = s + (is_hi ? 1e6 : 0), -1 where s <= 0, in
// f32 as ops/select.py computes it; each lane scans its pixels of the cell
// in flat order keeping the first maximum, and a shuffle reduction keeps
// the lowest flat index among equal maxima (argmax order).  The cell's
// (prio, index, score) goes to the workspace.  Slots that no cell fills (a
// level with fewer cells than its budget; n_features past the budgets) are
// written as zeros here.
// Stage B (describe_cells): the CTA copies its level's winners' prio to
// shared memory (its one barrier), and each warp counts the cells with
// greater prio, or equal prio and a lower index: its cell's rank in a
// stable descending sort, which is lax.top_k's order.  A rank below
// k = min(budget, cells) is the cell's slot in the level's part of the
// frame's arrays; the other warps (about three in four) exit.  The warp
// writes the keypoint (level-0 xy, response, octave, valid = prio > 0),
// then the moments m10, m01 and the masked sum over the 31x31 patch (lane
// = column, one row a step, the 31 rows read before any sum and kept in
// registers), and the masked variance in a second pass, all as butterfly
// shuffle reductions, so every lane holds the same sums and computes the
// same angle and bin: no barrier and no broadcast.  The 512 bit pairs are
// 16 ballots, one little-endian descriptor word each; the sample offsets
// come from a table of linear offsets (dy * W0 + dx, made once per frame
// width), so each pair's p and q offsets are one 8-byte load, and all of a
// lane's loads are issued before the ballots.
// Measured on the H100, one warp per cell and four CTAs per SM beat ranking
// several cells a warp and handing the selected ones round (PERF.md §6).
// Compiled with --fmad=false so products and sums round like the plain
// torch twin; the reduction order differs, so the angle may differ by ulps
// (tolerance in the parity tests).  Selection is exact.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define WPC (NT / 32)   // warps a CTA, one cell each
#define HALF 15
#define SIDE 31
#define NBITS 512
#define NBINS 32
#define WORDS 16
#define MAX_LEVELS 16
#define FULL 0xffffffffu

// Field order and types mirror kernels/orb_describe.py:_Level / _DescribeArgs.
struct Level {
    int h, w, cs, gw, n_cells, cell_base, cta_base, k, off, budget;
    float scale;
};

struct DescribeArgs {
    const float* pyr; const float* blur; const float* score; const uint8_t* is_hi;
    const int2* brief;  // [NBINS, NBITS] (p, q) sample offsets as dy * W0 + dx
    int* cells;         // [3, total cells]: prio (f32 bits), flat index, score (f32 bits)
    float* xy; float* resp; int* octave; float* angle; int* desc; uint8_t* valid;
    Level lv[MAX_LEVELS];
    int umax[HALF + 1];
    float n_circ, sum_r2, two_pi, bin_width;
    int n_levels, n_ctas, total_cells, max_cells, H0, W0, brief_half, n_features;
};

// the level whose cells CTA `cta` takes
__device__ __forceinline__ int level_of_cta(const DescribeArgs& a, int cta) {
    int l = 0;
    while (l + 1 < a.n_levels && cta >= a.lv[l + 1].cta_base) ++l;
    return l;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

__global__ void __launch_bounds__(NT, 8) select_cells(const DescribeArgs a) {
    // slots that no cell fills: zeros, octave = the level whose budget holds them
    for (int s = blockIdx.x * NT + threadIdx.x; s < a.n_features; s += gridDim.x * NT) {
        int lev = 0;
        bool pad = true;
        for (int l = 0; l < a.n_levels; ++l) {
            const int r = s - a.lv[l].off;
            if (r >= 0 && r < a.lv[l].budget) { lev = l; pad = r >= a.lv[l].k; break; }
        }
        if (pad) {
            a.xy[2 * s] = 0.0f;
            a.xy[2 * s + 1] = 0.0f;
            a.resp[s] = 0.0f;
            a.octave[s] = lev;
            a.angle[s] = 0.0f;
            a.valid[s] = 0;
            for (int w = 0; w < WORDS; ++w) a.desc[s * WORDS + w] = 0;
        }
    }
    if ((int)blockIdx.x >= a.n_ctas) return;
    const int l = level_of_cta(a, blockIdx.x);
    const int lane = threadIdx.x & 31;
    const int c = (blockIdx.x - a.lv[l].cta_base) * WPC + (threadIdx.x >> 5);
    if (c >= a.lv[l].n_cells) return;
    const int cs = a.lv[l].cs, lg = __ffs(cs) - 1;   // cs: a power of 2
    const int cy = c / a.lv[l].gw, cx = c % a.lv[l].gw;
    const size_t base = (size_t)l * a.H0 * a.W0 + (size_t)(cy * cs) * a.W0 + cx * cs;
    float bp = -2.0f, bs = 0.0f;
    int bi = 0;
#pragma unroll 8
    for (int i = lane; i < cs * cs; i += 32) {
        const size_t p = base + (size_t)(i >> lg) * a.W0 + (i & (cs - 1));
        const float s = a.score[p];
        const bool hi = a.is_hi[p] != 0;
        const float pr = s > 0.0f ? s + (hi ? 1e6f : 0.0f) : -1.0f;
        if (pr > bp) { bp = pr; bi = i; bs = s; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float op = __shfl_xor_sync(FULL, bp, o);
        const int oi = __shfl_xor_sync(FULL, bi, o);
        const float os = __shfl_xor_sync(FULL, bs, o);
        if (op > bp || (op == bp && oi < bi)) { bp = op; bi = oi; bs = os; }
    }
    if (lane == 0) {
        const int g = a.lv[l].cell_base + c;
        a.cells[g] = __float_as_int(bp);
        a.cells[a.total_cells + g] = bi;
        a.cells[2 * a.total_cells + g] = __float_as_int(bs);
    }
}

// One selected cell winner of level l: its keypoint at `slot`, its angle
// and its descriptor, by one warp.
__device__ __forceinline__ void describe_one(const DescribeArgs& a, int l, int c, int slot,
                                             int lane) {
    const int g = a.lv[l].cell_base + c, cs = a.lv[l].cs, gw = a.lv[l].gw;
    const int h = a.lv[l].h, w = a.lv[l].w;
    const float pc = __int_as_float(a.cells[g]);
    const int bi = a.cells[a.total_cells + g];
    const int xr = (c % gw) * cs + bi % cs, yr = (c / gw) * cs + bi / cs;
    const bool v = pc > 0.0f;
    if (lane == 0) {
        a.xy[2 * slot] = (float)xr * a.lv[l].scale;
        a.xy[2 * slot + 1] = (float)yr * a.lv[l].scale;
        a.resp[slot] = __int_as_float(a.cells[2 * a.total_cells + g]);
        a.octave[slot] = l;
        a.valid[slot] = v;
    }

    // IC angle: moments over the patch circle, centre clipped into the level
    const int x0 = min(max(xr, HALF), w - HALF - 1);
    const int y0 = min(max(yr, HALF), h - HALF - 1);
    const float* img = a.pyr + (size_t)l * a.H0 * a.W0 + (size_t)(y0 - HALF) * a.W0 + (x0 - HALF);
    // lane = column dx + 15 (lane 31 idles), one patch row a step: a row's
    // pixels are one coalesced read and its circle half-width is uniform.
    // The whole square is read (it lies inside the level) before any sum.
    const int dx = lane - HALF;
    float pv[SIDE];
#pragma unroll
    for (int r = 0; r < SIDE; ++r) pv[r] = img[r * a.W0 + min(lane, SIDE - 1)];
    float a10 = 0.0f, a01 = 0.0f, asum = 0.0f;
#pragma unroll
    for (int r = 0; r < SIDE; ++r) {
        const int dy = r - HALF;
        if (lane < SIDE && abs(dx) <= a.umax[abs(dy)]) {
            a10 += pv[r] * (float)dx;
            a01 += pv[r] * (float)dy;
            asum += pv[r];
        }
    }
    const float m10 = warp_sum(a10), m01 = warp_sum(a01);
    const float mu = warp_sum(asum) / a.n_circ;
    float av = 0.0f;
#pragma unroll
    for (int r = 0; r < SIDE; ++r) {
        if (lane < SIDE && abs(dx) <= a.umax[abs(r - HALF)]) {
            const float d = pv[r] - mu;
            av += d * d;
        }
    }
    const float var = warp_sum(av) / a.n_circ;
    // every lane holds the same sums: each computes the same angle and bin
    const float mag2 = m10 * m10 + m01 * m01;
    const bool strong = mag2 > 4.0f * var * a.sum_r2;
    const float ang = (v && strong) ? atan2f(m01, m10) : 0.0f;
    float rr = fmodf(ang, a.two_pi);
    if (rr != 0.0f && (rr < 0.0f) != (a.two_pi < 0.0f)) rr += a.two_pi;
    const int bin = ((int)rintf(rr / a.bin_width)) % NBINS;
    if (lane == 0) a.angle[slot] = ang;

    // steered BRIEF: bit k = p < q at the bin's rotated offsets; all 32 of
    // the lane's samples are read before the 16 ballots
    const int xb = min(max(xr, a.brief_half), w - a.brief_half - 1);
    const int yb = min(max(yr, a.brief_half), h - a.brief_half - 1);
    const float* bimg = a.blur + (size_t)l * a.H0 * a.W0 + (size_t)yb * a.W0 + xb;
    const int2* off = a.brief + (size_t)bin * NBITS + lane;
    int2 o[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) o[k] = __ldg(off + 32 * k);
    float p[WORDS], q[WORDS];
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
        p[k] = bimg[o[k].x];
        q[k] = bimg[o[k].y];
    }
    unsigned mine = 0;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
        const unsigned word = __ballot_sync(FULL, p[k] < q[k]);
        if (lane == k) mine = word;
    }
    if (lane < WORDS) a.desc[slot * WORDS + lane] = v ? (int)mine : 0;
}

__global__ void __launch_bounds__(NT, 4) describe_cells(const DescribeArgs a) {
    extern __shared__ float sprio[];            // the level's cell winners' prio
    const int l = level_of_cta(a, blockIdx.x);
    const int lane = threadIdx.x & 31;
    const int n = a.lv[l].n_cells;
    const float* prio = reinterpret_cast<const float*>(a.cells) + a.lv[l].cell_base;
    for (int j = threadIdx.x; j < n; j += NT) sprio[j] = __ldg(prio + j);
    __syncthreads();
    const int c = (blockIdx.x - a.lv[l].cta_base) * WPC + (threadIdx.x >> 5);
    if (c >= n) return;
    // the cell's rank among the level's winners
    const float pc = sprio[c];
    int cnt = 0;
    for (int j = lane; j < n; j += 32) {
        const float pj = sprio[j];
        cnt += (pj > pc) || (pj == pc && j < c);
    }
    const int rank = __reduce_add_sync(FULL, cnt), slot = a.lv[l].off + rank;
    if (rank < a.lv[l].k && slot < a.n_features) describe_one(a, l, c, slot, lane);
}

extern "C" int orb_describe_launch(const DescribeArgs* a, cudaStream_t stream) {
    const int n_pad_ctas = (a->n_features + NT - 1) / NT;
    const int grid_a = a->n_ctas > n_pad_ctas ? a->n_ctas : n_pad_ctas;
    const size_t smem = (size_t)a->max_cells * sizeof(float);
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(describe_cells, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (grid_a > 0) select_cells<<<grid_a, NT, 0, stream>>>(*a);
    if (a->n_ctas > 0) describe_cells<<<a->n_ctas, NT, smem, stream>>>(*a);
    return (int)cudaGetLastError();
}
