// FAST-9/16 score + 3x3 non-maximum suppression + EDGE margin, one pyramid level.
//
// Replaces (JAX reference, fused by XLA): ops/fast.py fast_score_map and
// nms3x3, plus the margin mask of ops/extractor.py _select_level.
//
// Bound: arithmetic.  Each pixel reads its 16-pixel Bresenham circle (from
// L1/L2) and does ~600 min/max/compare operations for 4 bytes in and 5
// bytes out, so VGA level 0 is ~0.18 G operations (~10 us at the FP32
// issue rate) against ~3 MB of device-memory traffic (~1 us).  At these
// sizes the 8 launches per frame cost more than either.
//
// Design: one thread per output pixel in 32x8 blocks.  The block first
// computes the thresholded score of its tile plus a one-pixel halo into
// shared memory (each circle read hits L1/L2), then applies NMS from shared
// memory, so the score map never goes to device memory before suppression.
// Comparisons and min/max are exact, so the result equals the plain torch
// version bit for bit (compiled with --fmad=false all the same).

#include <cuda_runtime.h>
#include <stdint.h>

#define TX 32
#define TY 8

__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ float arc_strength(const float* d, float sgn) {
    float best = -INFINITY;
    for (int s = 0; s < 16; ++s) {
        float run = sgn * d[s];
        for (int i = 1; i < 9; ++i) run = fminf(run, sgn * d[(s + i) & 15]);
        best = fmaxf(best, run);
    }
    return best;
}

__device__ __forceinline__ float score_lo(const float* img, int W, int y, int x) {
    float c = img[y * W + x];
    float d[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = img[(y + c_dy[i]) * W + (x + c_dx[i])] - c;
    return fmaxf(arc_strength(d, 1.0f), arc_strength(d, -1.0f));
}

__global__ void fast_nms_kernel(const float* __restrict__ img, int H, int W,
                                float thr_lo, float thr_hi, int margin,
                                float* __restrict__ score_out,
                                uint8_t* __restrict__ is_hi_out) {
    __shared__ float tile[TY + 2][TX + 2];
    const int bx = blockIdx.x * TX, by = blockIdx.y * TY;
    const int tid = threadIdx.y * TX + threadIdx.x;
    for (int i = tid; i < (TY + 2) * (TX + 2); i += TX * TY) {
        int ty = i / (TX + 2), tx = i % (TX + 2);
        int y = by + ty - 1, x = bx + tx - 1;
        float sc = 0.0f;
        bool hi = false;
        if (y >= 3 && y < H - 3 && x >= 3 && x < W - 3) {
            float v = score_lo(img, W, y, x);
            sc = v > thr_lo ? v : 0.0f;
            hi = v > thr_hi;
        }
        tile[ty][tx] = sc;
        bool own = tx >= 1 && tx <= TX && ty >= 1 && ty <= TY;
        if (own && y < H && x < W) is_hi_out[y * W + x] = hi ? 1 : 0;
    }
    __syncthreads();
    const int x = bx + threadIdx.x, y = by + threadIdx.y;
    if (x >= W || y >= H) return;
    const float c = tile[threadIdx.y + 1][threadIdx.x + 1];
    float m = c;
    for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, tile[threadIdx.y + dy][threadIdx.x + dx]);
    const bool inside = y >= margin && y < H - margin && x >= margin && x < W - margin;
    score_out[y * W + x] = (inside && c >= m) ? c : 0.0f;
}

extern "C" int fast_nms_launch(const float* img, float* score, uint8_t* is_hi, int H, int W,
                               float thr_lo, float thr_hi, int margin, cudaStream_t stream) {
    dim3 block(TX, TY);
    dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
    fast_nms_kernel<<<grid, block, 0, stream>>>(img, H, W, thr_lo, thr_hi, margin, score, is_hi);
    return (int)cudaGetLastError();
}
