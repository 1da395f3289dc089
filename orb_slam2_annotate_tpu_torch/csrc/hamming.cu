// Bit-packed Hamming matching: (a) fused masked match, (b) batched all-pairs.
//
// Replaces (JAX reference): ops/hamming.py hamming_pairwise + masked_min2
// and ops/matching.py match_masked (a); the vmapped pairwise Hamming of
// worldmap/map_state.py _stats_from_table (b).
//
// Bound: (a) reads the [N1,N2] candidate mask (4 MB at 4096x1024) once and
// does N1*N2*16 XOR+popcount; the descriptors (64 B each) stay in L1/L2.
// The reference materializes the [N1,N2] distance matrix and reduces it
// three times; this kernel never writes it.
//
// Design (a): launch 1 resets the per-column keys.  Launch 2 runs one block
// per query row: each thread takes columns j = tid, tid+256, ...; masked
// distances go to shared memory (unmasked read MAX_DIST = 512, as in the
// reference) and to a per-column atomicMin of the packed key
// (dist << 32 | row), which yields both the column minimum and the lowest
// row attaining it.  Block reductions then give the best distance, its
// first column index, and the second best (the minimum over every other
// column, so ties give second == best).  Launch 3 applies the distance
// gate, the ratio test and either the column-min dedup or the mutual
// row-argmin check, one thread per row.  All outputs are integers, equal
// to the plain torch version's.
//
// Design (b): one block per point, one thread per (i, j) pair.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define WORDS 16
#define MAX_DIST 512

__global__ void reset_keys(unsigned long long* colkey, int N2) {
    int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j < N2) colkey[j] = ((unsigned long long)MAX_DIST) << 32;   // row 0 at MAX_DIST
}

__global__ void match_rows(const int* __restrict__ d1, const int* __restrict__ d2,
                           const uint8_t* __restrict__ mask, int N2,
                           unsigned long long* __restrict__ colkey,
                           int* __restrict__ best_out, int* __restrict__ bidx_out,
                           int* __restrict__ second_out) {
    extern __shared__ int sd[];              // [N2] masked distances
    __shared__ int q[WORDS];
    __shared__ int rv[NT / 32], ri[NT / 32];
    const int i = blockIdx.x, tid = threadIdx.x;
    if (tid < WORDS) q[tid] = d1[i * WORDS + tid];
    __syncthreads();
    int bv = MAX_DIST + 1, bi = 0x7fffffff;
    const uint8_t* mrow = mask + (size_t)i * N2;
    for (int j = tid; j < N2; j += NT) {
        int d = MAX_DIST;
        if (mrow[j]) {
            d = 0;
            const int* b = d2 + (size_t)j * WORDS;
#pragma unroll
            for (int w = 0; w < WORDS; ++w) d += __popc((unsigned)(q[w] ^ b[w]));
            atomicMin(&colkey[j], (((unsigned long long)d) << 32) | (unsigned)i);
        }
        sd[j] = d;
        if (d < bv) { bv = d; bi = j; }      // j increases: first index kept on ties
    }
    // block argmin of (value, index)
    for (int o = 16; o > 0; o >>= 1) {
        int ov = __shfl_down_sync(0xffffffffu, bv, o);
        int oi = __shfl_down_sync(0xffffffffu, bi, o);
        if (ov < bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    if ((tid & 31) == 0) { rv[tid >> 5] = bv; ri[tid >> 5] = bi; }
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < NT / 32; ++w)
            if (rv[w] < rv[0] || (rv[w] == rv[0] && ri[w] < ri[0])) { rv[0] = rv[w]; ri[0] = ri[w]; }
    }
    __syncthreads();
    const int best = rv[0], bidx = ri[0];
    __syncthreads();
    int sv = MAX_DIST;
    for (int j = tid; j < N2; j += NT)
        if (j != bidx) sv = min(sv, sd[j]);
    for (int o = 16; o > 0; o >>= 1) sv = min(sv, __shfl_down_sync(0xffffffffu, sv, o));
    if ((tid & 31) == 0) rv[tid >> 5] = sv;
    __syncthreads();
    if (tid == 0) {
        int s = rv[0];
        for (int w = 1; w < NT / 32; ++w) s = min(s, rv[w]);
        best_out[i] = best;
        bidx_out[i] = bidx;
        second_out[i] = s;
    }
}

__global__ void match_finish(const int* __restrict__ best, const int* __restrict__ bidx,
                             const int* __restrict__ second,
                             const unsigned long long* __restrict__ colkey, int N1,
                             int max_dist, float ratio, int mutual,
                             int* __restrict__ idx_out, int* __restrict__ dist_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N1) return;
    const int b = best[i], j = bidx[i];
    bool ok = b <= max_dist && (float)b < ratio * (float)second[i];
    const unsigned long long key = colkey[j];
    if (mutual) ok = ok && (int)(key & 0xffffffffull) == i;
    else ok = ok && b <= (int)(key >> 32);
    idx_out[i] = ok ? j : -1;
    dist_out[i] = ok ? b : MAX_DIST;
}

__global__ void pairwise_batched(const int* __restrict__ a, const int* __restrict__ b,
                                 int M, int* __restrict__ out) {
    const int qi = blockIdx.x;
    const int* A = a + (size_t)qi * M * WORDS;
    const int* B = b + (size_t)qi * M * WORDS;
    for (int p = threadIdx.x; p < M * M; p += blockDim.x) {
        const int i = p / M, j = p % M;
        int d = 0;
#pragma unroll
        for (int w = 0; w < WORDS; ++w) d += __popc((unsigned)(A[i * WORDS + w] ^ B[j * WORDS + w]));
        out[(size_t)qi * M * M + p] = d;
    }
}

extern "C" int hamming_match_launch(const int* d1, const int* d2, const uint8_t* mask,
                                    int N1, int N2, int max_dist, float ratio, int mutual,
                                    unsigned long long* colkey, int* best, int* bidx, int* second,
                                    int* idx_out, int* dist_out, cudaStream_t stream) {
    if (N1 == 0) return (int)cudaGetLastError();
    const size_t smem = (size_t)N2 * sizeof(int);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(match_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    reset_keys<<<(N2 + NT - 1) / NT, NT, 0, stream>>>(colkey, N2);
    match_rows<<<N1, NT, smem, stream>>>(d1, d2, mask, N2, colkey, best, bidx, second);
    match_finish<<<(N1 + NT - 1) / NT, NT, 0, stream>>>(best, bidx, second, colkey, N1, max_dist,
                                                         ratio, mutual, idx_out, dist_out);
    return (int)cudaGetLastError();
}

extern "C" int hamming_pairwise_batched_launch(const int* a, const int* b, int Q, int M, int* out,
                                               cudaStream_t stream) {
    if (Q > 0) pairwise_batched<<<Q, NT, 0, stream>>>(a, b, M, out);
    return (int)cudaGetLastError();
}
