// Kernel 6: inlier counts of batched PnP hypotheses.
//
// Replaces (JAX reference): the vmapped `score` of solvers/pnp.py pnp_ransac
// (reprojection of every correspondence under every DLT hypothesis), run
// across the 8 candidates of pipeline/tracking.py relocalize_candidates.  On
// the main path C = 8 candidates x S = 256 hypotheses x N = 1024 points:
// 2.1M reprojections a relocalization attempt.
//
// Bound: ~20 flops and one division a reprojection; the inputs (12 KB of
// points per candidate) stay in L1/L2, so it is latency and issue bound.
// The reference builds [S,N] chi2 planes per candidate and sums them; this
// kernel keeps only the count.
//
// Design: one block per hypothesis (c, s), the pose in registers, threads
// stride over the N points, a warp-shuffle and shared-memory sum gives the
// count.  Built with --fmad=false and written in the plain twin's order of
// operations ((x R0 + y R1) + z R2 + t, (fx x) / z + cx - u, du^2 + dv^2),
// so every comparison sees the same float and the counts are equal.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256

__global__ void __launch_bounds__(NT) score(const float* __restrict__ Rs,
                                            const float* __restrict__ ts,
                                            const float* __restrict__ xw,
                                            const float* __restrict__ uv,
                                            const uint8_t* __restrict__ valid, int S, int N,
                                            float fx, float fy, float cx, float cy, float th,
                                            int* __restrict__ out) {
    __shared__ int warp_sum[NT / 32];
    const int h = blockIdx.x, c = h / S, tid = threadIdx.x;
    const float* R = Rs + (size_t)h * 9;
    const float* t = ts + (size_t)h * 3;
    const float r00 = R[0], r01 = R[1], r02 = R[2], r10 = R[3], r11 = R[4], r12 = R[5],
                r20 = R[6], r21 = R[7], r22 = R[8], t0 = t[0], t1 = t[1], t2 = t[2];
    const float* X = xw + (size_t)c * N * 3;
    const uint8_t* ok = valid + (size_t)c * N;
    int n_in = 0;
    for (int n = tid; n < N; n += NT) {
        const float x = X[3 * n], y = X[3 * n + 1], z = X[3 * n + 2];
        const float xc = ((x * r00 + y * r01) + z * r02) + t0;
        const float yc = ((x * r10 + y * r11) + z * r12) + t1;
        const float zc = ((x * r20 + y * r21) + z * r22) + t2;
        const bool zok = zc > 1e-3f;
        const float zs = zok ? zc : 1.0f;
        const float du = (fx * xc / zs + cx) - uv[2 * n];
        const float dv = (fy * yc / zs + cy) - uv[2 * n + 1];
        n_in += (ok[n] && zok && (du * du + dv * dv < th)) ? 1 : 0;
    }
    for (int o = 16; o > 0; o >>= 1) n_in += __shfl_down_sync(0xffffffffu, n_in, o);
    if ((tid & 31) == 0) warp_sum[tid >> 5] = n_in;
    __syncthreads();
    if (tid == 0) {
        int s = 0;
        for (int w = 0; w < NT / 32; ++w) s += warp_sum[w];
        out[h] = s;
    }
}

extern "C" int pnp_score_launch(const float* Rs, const float* ts, const float* xw, const float* uv,
                                const uint8_t* valid, int C, int S, int N, float fx, float fy,
                                float cx, float cy, float th, int* out, cudaStream_t stream) {
    if (C * S > 0) score<<<C * S, NT, 0, stream>>>(Rs, ts, xw, uv, valid, S, N, fx, fy, cx, cy, th, out);
    return (int)cudaGetLastError();
}
