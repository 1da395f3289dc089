// Per-keypoint IC orientation + steered BRIEF, all pyramid levels at once.
//
// Replaces (JAX reference): ops/orb.py keypoint_patches, ic_angles_patches
// and brief_descriptors_patches.  The reference evaluates the 512 bits as a
// [N,1369]x[32,1369,512] +-1 matmul (a TPU matrix-unit device); each bit is
// exactly the direct compare p < q, which this kernel does.
//
// Bound: latency of scattered reads.  Per keypoint it reads a 31x31 patch
// (961 floats) and 1024 scattered samples of the blurred level, ~8 KB,
// i.e. ~8 MB for 1024 keypoints; arithmetic is ~3k flops per keypoint.
//
// Design: one block of 512 threads per keypoint.  The moments m10, m01 and
// the masked sum are block reductions over the patch, then the masked
// variance a second one (as the reference computes it, two passes).  Thread
// 0 derives angle and angle bin; then each thread compares one bit pair and
// a warp ballot packs 32 bits little-endian into one descriptor word.
// Compiled with --fmad=false so the moment products round like the plain
// torch version; reduction order still differs (see the tolerance in the
// parity tests), so only the angle may differ by ulps.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 512
#define HALF 15
#define SIDE 31
#define NBITS 512
#define NBINS 32

__device__ __forceinline__ float block_sum(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.0f;
    if (threadIdx.x == 0) {
        for (int w = 0; w < NT / 32; ++w) s += red[w];
        red[NT / 32] = s;
    }
    __syncthreads();
    return red[NT / 32];
}

__global__ void orb_describe_kernel(const float* __restrict__ pyr, const float* __restrict__ pyr_blur,
                                    int H0, int W0, const int* __restrict__ level_hw,
                                    const float* __restrict__ kps, const int* __restrict__ octave,
                                    const uint8_t* __restrict__ valid,
                                    const float* __restrict__ grid_x, const float* __restrict__ grid_y,
                                    const float* __restrict__ circ_mask,
                                    const int* __restrict__ rot_offsets,
                                    float n_circ, float sum_r2, int brief_half,
                                    float two_pi, float bin_width,
                                    float* __restrict__ angle_out, int* __restrict__ desc_out) {
    __shared__ float red[NT / 32 + 1];
    __shared__ int s_bin;
    const int k = blockIdx.x, tid = threadIdx.x;
    const int o = octave[k];
    const int h = level_hw[2 * o], w = level_hw[2 * o + 1];
    const int xr = (int)rintf(kps[2 * k]), yr = (int)rintf(kps[2 * k + 1]);
    const int x0 = min(max(xr, HALF), w - HALF - 1);
    const int y0 = min(max(yr, HALF), h - HALF - 1);
    const float* img = pyr + (size_t)o * H0 * W0;

    float a10 = 0.0f, a01 = 0.0f, asum = 0.0f;
    for (int i = tid; i < SIDE * SIDE; i += NT) {
        const float p = img[(y0 - HALF + i / SIDE) * W0 + (x0 - HALF + i % SIDE)];
        a10 += p * grid_x[i];
        a01 += p * grid_y[i];
        asum += p * circ_mask[i];
    }
    const float m10 = block_sum(a10, red);
    const float m01 = block_sum(a01, red);
    const float mu = block_sum(asum, red) / n_circ;
    float av = 0.0f;
    for (int i = tid; i < SIDE * SIDE; i += NT) {
        const float d = img[(y0 - HALF + i / SIDE) * W0 + (x0 - HALF + i % SIDE)] - mu;
        av += d * d * circ_mask[i];
    }
    const float var = block_sum(av, red) / n_circ;
    const bool v = valid[k] != 0;

    if (tid == 0) {
        const float mag2 = m10 * m10 + m01 * m01;
        const bool strong = mag2 > 4.0f * var * sum_r2;
        const float ang = (v && strong) ? atan2f(m01, m10) : 0.0f;
        angle_out[k] = ang;
        float r = fmodf(ang, two_pi);
        if (r != 0.0f && (r < 0.0f) != (two_pi < 0.0f)) r += two_pi;
        s_bin = ((int)rintf(r / bin_width)) % NBINS;
    }
    __syncthreads();

    const int xb = min(max(xr, brief_half), w - brief_half - 1);
    const int yb = min(max(yr, brief_half), h - brief_half - 1);
    const float* bimg = pyr_blur + (size_t)o * H0 * W0;
    const int* off = rot_offsets + (size_t)s_bin * 2 * NBITS * 2;
    const int bp = tid, bq = tid + NBITS;
    const float pv = bimg[(yb + off[2 * bp]) * W0 + xb + off[2 * bp + 1]];
    const float qv = bimg[(yb + off[2 * bq]) * W0 + xb + off[2 * bq + 1]];
    const unsigned word = __ballot_sync(0xffffffffu, pv < qv);
    if ((tid & 31) == 0) desc_out[k * (NBITS / 32) + (tid >> 5)] = v ? (int)word : 0;
}

extern "C" int orb_describe_launch(const float* pyr, const float* pyr_blur, int H0, int W0,
                                   const int* level_hw, const float* kps, const int* octave,
                                   const uint8_t* valid, const float* grid_x, const float* grid_y,
                                   const float* circ_mask, const int* rot_offsets,
                                   float n_circ, float sum_r2, int brief_half,
                                   float two_pi, float bin_width, int N,
                                   float* angle_out, int* desc_out, cudaStream_t stream) {
    if (N > 0)
        orb_describe_kernel<<<N, NT, 0, stream>>>(pyr, pyr_blur, H0, W0, level_hw, kps, octave,
                                                  valid, grid_x, grid_y, circ_mask, rot_offsets,
                                                  n_circ, sum_r2, brief_half, two_pi, bin_width,
                                                  angle_out, desc_out);
    return (int)cudaGetLastError();
}
