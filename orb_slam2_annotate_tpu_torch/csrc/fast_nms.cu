// A frame's whole image pyramid in one launch: resize, 7-tap Gaussian blur,
// FAST-9/16 score, 3x3 non-maximum suppression and the EDGE margin, for
// every level.
//
// Replaces (JAX reference, fused by XLA per level): ops/pyramid.py
// build_pyramid and gaussian_blur, ops/fast.py fast_score_map and nms3x3,
// the margin mask of ops/extractor.py _select_level, and the padded stacks
// of ops/extractor.py _extract_jit.
//
// Outputs, each an [L,H0,W0] stack, zero outside level l's (h, w): pyr3 (the
// levels), pyr3_blur (reflect-101 blur at each level's own border), score
// (thresholded FAST after NMS and margin) and is_hi (uint8).
//
// Bound: bytes.  The image in (1.2 MB at VGA) and the four stacks out
// (13 B a stack pixel, 32 MB at VGA x 8 levels) take ~10 us at 3.35 TB/s;
// the operations (a few resize taps, 14 blur multiply-adds and ~600 FAST
// compares per level pixel, ~0.8 G in all) take ~12 us at 67 T/s, and so
// weigh about the same.  The design makes the frame one launch: no level
// image, blurred image or unsuppressed score map goes to device memory and
// comes back.
//
// Design: grid (W0 / 32, H0 / 16, L), 256 threads; each CTA owns a 32x16
// tile of one level's stack.  Every level is resized from level 0 (as the
// reference does), so the tiles are independent: the CTA computes its tile
// plus a 4-pixel halo of the level directly from the level-0 image, as the
// banded sum out(y, x) = sum_kx cw[kx] * (sum_ky rw[ky] * img[y0+ky, x0+kx])
// over per-output tap tables (ops/pyramid.py level_tables, made once per
// shape), into shared memory.  FAST + NMS then read only shared memory (the
// thresholded score of the tile plus a 1-pixel halo, then the 3x3 maximum),
// and the blur's vertical pass writes a shared [16, 38] strip that its
// horizontal pass reads; reflect-101 indices stay inside the halo.  Tiles
// wholly outside their level only write zeros.
//
// Bit for bit as the plain torch version (ops/pyramid.py resize_stack and
// gaussian_blur, kernels/fast_nms.py fast_nms_plain): the same taps summed
// in the same order from 0, the blur's terms in gaussian_blur's order,
// compiled with --fmad=false; comparisons and min / max are exact.

#include <cuda_runtime.h>
#include <stdint.h>

#define TX 32
#define TY 16
#define HALO 4
#define SW (TX + 2 * HALO)
#define SH (TY + 2 * HALO)
#define NT 256

__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// Field order and types mirror kernels/fast_nms.py:_PyrArgs.
struct PyrArgs {
    const float* img;                               // [H0,W0]
    const int* level_hw;                            // [L,2]
    const int* n_taps;                              // [L,2] row, column taps
    const int* row_first; const float* row_w;       // [L,H0], [L,H0,T]
    const int* col_first; const float* col_w;       // [L,W0], [L,W0,T]
    float* pyr3; float* blur; float* score; uint8_t* is_hi;   // [L,H0,W0]
    float k[7];                                     // blur taps
    float thr_lo, thr_hi;
    int H0, W0, T, margin;
};

__device__ __forceinline__ float arc_strength(const float* d, float sgn) {
    float best = -INFINITY;
    for (int s = 0; s < 16; ++s) {
        float run = sgn * d[s];
        for (int i = 1; i < 9; ++i) run = fminf(run, sgn * d[(s + i) & 15]);
        best = fmaxf(best, run);
    }
    return best;
}

__device__ __forceinline__ int reflect101(int i, int n) {
    return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// level l at (y, x), summed from the level-0 image in resize_stack's order
__device__ __forceinline__ float resize_px(const PyrArgs& a, int l, int y, int x, int ty, int tx) {
    const int fy = a.row_first[l * a.H0 + y], fx = a.col_first[l * a.W0 + x];
    const float* rw = a.row_w + ((size_t)l * a.H0 + y) * a.T;
    const float* cw = a.col_w + ((size_t)l * a.W0 + x) * a.T;
    float acc = 0.0f;
    for (int kx = 0; kx < tx; ++kx) {
        const float* col = a.img + min(fx + kx, a.W0 - 1);
        float t = 0.0f;
        for (int ky = 0; ky < ty; ++ky) t = t + rw[ky] * col[(size_t)min(fy + ky, a.H0 - 1) * a.W0];
        acc = acc + cw[kx] * t;
    }
    return acc;
}

__global__ void __launch_bounds__(NT) pyramid_fast_nms(const PyrArgs a) {
    __shared__ float S[SH][SW];              // the level's tile + 4-pixel halo
    __shared__ float SC[TY + 2][TX + 2];     // thresholded FAST score, tile + 1
    __shared__ float V[TY][TX + 6];          // blur, vertical pass
    const int l = blockIdx.z, x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, tid = threadIdx.x;
    const int h = a.level_hw[2 * l], w = a.level_hw[2 * l + 1];
    const size_t plane = (size_t)l * a.H0 * a.W0;

    if (x0 >= w || y0 >= h) {                // padding only
        for (int i = tid; i < TX * TY; i += NT) {
            const int y = y0 + i / TX, x = x0 + i % TX;
            if (y < a.H0 && x < a.W0) {
                const size_t o = plane + (size_t)y * a.W0 + x;
                a.pyr3[o] = 0.0f; a.blur[o] = 0.0f; a.score[o] = 0.0f; a.is_hi[o] = 0;
            }
        }
        return;
    }
    const int ty = a.n_taps[2 * l], tx = a.n_taps[2 * l + 1];
    for (int i = tid; i < SH * SW; i += NT) {
        const int y = y0 - HALO + i / SW, x = x0 - HALO + i % SW;
        S[i / SW][i % SW] = (y >= 0 && y < h && x >= 0 && x < w) ? resize_px(a, l, y, x, ty, tx) : 0.0f;
    }
    __syncthreads();

    // FAST score of the tile + 1-pixel halo; is_hi of the tile
    for (int i = tid; i < (TY + 2) * (TX + 2); i += NT) {
        const int sy = i / (TX + 2), sx = i % (TX + 2);
        const int y = y0 - 1 + sy, x = x0 - 1 + sx;
        float sc = 0.0f;
        bool hi = false;
        if (y >= 3 && y < h - 3 && x >= 3 && x < w - 3) {
            const int cy = sy + HALO - 1, cx = sx + HALO - 1;
            const float c = S[cy][cx];
            float d[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) d[k] = S[cy + c_dy[k]][cx + c_dx[k]] - c;
            const float v = fmaxf(arc_strength(d, 1.0f), arc_strength(d, -1.0f));
            sc = v > a.thr_lo ? v : 0.0f;
            hi = v > a.thr_hi;
        }
        SC[sy][sx] = sc;
        const bool own = sy >= 1 && sy <= TY && sx >= 1 && sx <= TX;
        if (own && y < a.H0 && x < a.W0) a.is_hi[plane + (size_t)y * a.W0 + x] = hi ? 1 : 0;
    }

    // blur, vertical pass: V[r][c] at row y0 + r and (pre-reflection) column x0 - 3 + c
    for (int i = tid; i < TY * (TX + 6); i += NT) {
        const int r = i / (TX + 6), c = i % (TX + 6);
        const int y = y0 + r, q = reflect101(x0 - 3 + c, w);
        float acc = 0.0f;
        // columns that no in-level pixel of the tile reads may reflect out of the halo
        if (y < h && q >= x0 - HALO && q < x0 + TX + HALO) {
            const int sx = q - x0 + HALO;
            acc = a.k[0] * S[reflect101(y - 3, h) - y0 + HALO][sx];
            for (int k = 1; k < 7; ++k) acc = acc + a.k[k] * S[reflect101(y - 3 + k, h) - y0 + HALO][sx];
        }
        V[r][c] = acc;
    }
    __syncthreads();

    for (int i = tid; i < TY * TX; i += NT) {
        const int r = i / TX, c = i % TX, y = y0 + r, x = x0 + c;
        if (y >= a.H0 || x >= a.W0) continue;
        const size_t o = plane + (size_t)y * a.W0 + x;
        if (y >= h || x >= w) {
            a.pyr3[o] = 0.0f; a.blur[o] = 0.0f; a.score[o] = 0.0f;
            continue;
        }
        a.pyr3[o] = S[r + HALO][c + HALO];
        float b = a.k[0] * V[r][c];
        for (int k = 1; k < 7; ++k) b = b + a.k[k] * V[r][c + k];
        a.blur[o] = b;
        const float s = SC[r + 1][c + 1];
        float m = s;
        for (int dy = 0; dy < 3; ++dy)
            for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, SC[r + dy][c + dx]);
        const bool inside = y >= a.margin && y < h - a.margin && x >= a.margin && x < w - a.margin;
        a.score[o] = (inside && s >= m) ? s : 0.0f;
    }
}

extern "C" int fast_nms_launch(const PyrArgs* a, int n_levels, cudaStream_t stream) {
    dim3 grid((a->W0 + TX - 1) / TX, (a->H0 + TY - 1) / TY, n_levels);
    if (n_levels > 0) pyramid_fast_nms<<<grid, NT, 0, stream>>>(*a);
    return (int)cudaGetLastError();
}
