// Kernel 11: a segment sum in one fixed order.
//
//   out[s, :] = sum over rows e with idx[e] == s, in ascending e, from +0.0,
//               of vals[e, :]
//
// Replaces no Pallas kernel: it replaces the scatter-adds that XLA lowers
// in order on the reference's TPU, which the port's solvers wrote as
// torch's index_add / index_put_(accumulate=True).  On the card those are
// float atomics, whose order of addition changes from run to run, so a
// loop closure's pose graph and global BA gave other bits on every run.
// Call sites: solvers/pose_graph.py (g, the D blocks and the PCG product
// over the K keyframes, H over the K x K blocks), solvers/ba_cg.py (Hcc,
// gc over the cameras; Hpp, gp over the points; the two sums of each PCG
// product) and solvers/ba_core.py build_normal_eqs (Hcc, Hpp, gc, gp and B
// over the P x C point-camera pairs).
//
// The plan (kernels/segment_sum.py segment_plan, built once a solve on the
// card): perm [E] int32, the rows in ascending (segment, row) order from a
// stable sort of the index, rows outside [0, S) last; offsets [S + 1]
// int32, segment s's rows are perm[offsets[s] .. offsets[s + 1]).
//
// Bound: bytes.  Each input row read once (4 D bytes of values and its
// 4-byte index), each output row written once (4 D bytes) with its offset
// read (4 bytes); one add an element is far below the card's rate.
//
// Design: one warp a (segment, 32-column chunk), a lane a column, walking
// the segment's rows in ascending order with one dependent add each; the
// gathers of the next four rows are issued before their adds.  An empty
// segment writes +0.0.  The order is that of the CPU's serial index_add
// (kernels/segment_sum.py segment_sum_plain), so kernel and twin agree bit
// for bit; built with --fmad=false like the others (only adds here).

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8

__global__ void __launch_bounds__(WARPS * 32) segment_sum_kernel(
    const float* __restrict__ vals, const int* __restrict__ perm,
    const int* __restrict__ offsets, float* __restrict__ out, long long n_warps, int D,
    int chunks) {
    const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (w >= n_warps) return;
    const int lane = threadIdx.x & 31;
    const long long s = w / chunks;
    const int c = (int)(w - s * chunks) * 32 + lane;
    if (c >= D) return;
    const int b = offsets[s], e = offsets[s + 1];
    float acc = 0.f;
    int i = b;
    for (; i + 4 <= e; i += 4) {
        const int p0 = perm[i], p1 = perm[i + 1], p2 = perm[i + 2], p3 = perm[i + 3];
        const float v0 = vals[(size_t)p0 * D + c];
        const float v1 = vals[(size_t)p1 * D + c];
        const float v2 = vals[(size_t)p2 * D + c];
        const float v3 = vals[(size_t)p3 * D + c];
        acc = __fadd_rn(acc, v0);
        acc = __fadd_rn(acc, v1);
        acc = __fadd_rn(acc, v2);
        acc = __fadd_rn(acc, v3);
    }
    for (; i < e; ++i) acc = __fadd_rn(acc, vals[(size_t)perm[i] * D + c]);
    out[(size_t)s * D + c] = acc;
}

extern "C" int segment_sum_launch(const float* vals, const int* perm, const int* offsets,
                                  float* out, long long S, int D, cudaStream_t stream) {
    if (S == 0 || D == 0) return (int)cudaGetLastError();
    const int chunks = (D + 31) / 32;
    const long long n_warps = S * chunks;
    const long long blocks = (n_warps + WARPS - 1) / WARPS;
    segment_sum_kernel<<<(unsigned)blocks, WARPS * 32, 0, stream>>>(vals, perm, offsets, out,
                                                                   n_warps, D, chunks);
    return (int)cudaGetLastError();
}
