// Kernel 5: nearest vocabulary word per descriptor (Hamming argmin).
//
// Replaces (JAX reference): worldmap/vocabulary.py assign_words, i.e.
// ops/hamming.py hamming_pairwise(desc [N,16], words [W,16]) followed by the
// row argmin.  On the main path N = 1024 and W = 16384: 16.8M pairs, on every
// keyframe (BoW row of the database) and every relocalization attempt.
//
// Bound: XOR + popcount, 16 words a pair: 268M popcounts a call.  The
// reference materializes the [N,W] distance matrix (64 MB) and reduces it;
// this kernel never writes it.
//
// Design: block (x, y) takes QB = 32 query rows (in shared memory, read as
// broadcasts) against a chunk of WCHUNK vocabulary words.  Each thread holds
// WPT = 2 words in registers per step, so every query word read from shared
// memory serves two popcounts, and keeps its 32 per-query minima of the
// packed key (dist << 20 | word) in registers.  Since the word index is the
// low field, the minimum of the keys is the lowest word among equal
// distances: jnp.argmin's order.  Warp shuffles, a shared atomicMin and one
// global atomicMin per query combine the minima across threads and chunks.
// A last launch unpacks the word, -1 where the descriptor is not valid.
// All integer: equal to the plain torch twin.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define WORDS 16
#define QB 32
#define WPT 2
#define WCHUNK (NT * WPT * 4)
#define IDX_BITS 20

__global__ void reset_keys(unsigned* __restrict__ key, int N) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N) key[i] = 0xffffffffu;
}

__device__ __forceinline__ int popc4(int4 a, int4 b) {
    return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) + __popc(a.w ^ b.w);
}

__global__ void __launch_bounds__(NT) assign_tile(const int* __restrict__ desc,
                                                  const int* __restrict__ words, int N, int W,
                                                  unsigned* __restrict__ key) {
    __shared__ int4 q[QB][WORDS / 4];
    __shared__ unsigned sbest[QB];
    const int q0 = blockIdx.x * QB, w0 = blockIdx.y * WCHUNK, tid = threadIdx.x;
    for (int i = tid; i < QB * WORDS; i += NT) {
        const int r = i / WORDS, c = i % WORDS;
        reinterpret_cast<int*>(q)[i] = (q0 + r < N) ? desc[(size_t)(q0 + r) * WORDS + c] : 0;
    }
    if (tid < QB) sbest[tid] = 0xffffffffu;
    __syncthreads();

    unsigned best[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) best[r] = 0xffffffffu;
    for (int base = w0 + tid; base < min(W, w0 + WCHUNK); base += NT * WPT) {
        int4 wv[WPT][WORDS / 4];
        unsigned idx[WPT];
#pragma unroll
        for (int p = 0; p < WPT; ++p) {
            int j = base + p * NT;
            const bool in = j < W;
            idx[p] = in ? (unsigned)j : (1u << IDX_BITS) - 1;   // past the end: never the minimum
            j = in ? j : base;                                   // base < W: a valid row to read
            const int4* wp = reinterpret_cast<const int4*>(words + (size_t)j * WORDS);
#pragma unroll
            for (int c = 0; c < WORDS / 4; ++c) wv[p][c] = wp[c];
        }
#pragma unroll
        for (int r = 0; r < QB; ++r) {
            int d[WPT];
#pragma unroll
            for (int p = 0; p < WPT; ++p) d[p] = 0;
#pragma unroll
            for (int c = 0; c < WORDS / 4; ++c) {
                const int4 a = q[r][c];
#pragma unroll
                for (int p = 0; p < WPT; ++p) d[p] += popc4(a, wv[p][c]);
            }
#pragma unroll
            for (int p = 0; p < WPT; ++p) {
                // a past-the-end word gets distance 2047: above any real one
                const unsigned dist = idx[p] == (1u << IDX_BITS) - 1 ? 2047u : (unsigned)d[p];
                best[r] = min(best[r], (dist << IDX_BITS) | idx[p]);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < QB; ++r) {
        unsigned b = best[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) b = min(b, __shfl_xor_sync(0xffffffffu, b, o));
        if ((tid & 31) == 0) atomicMin(&sbest[r], b);
    }
    __syncthreads();
    if (tid < QB && q0 + tid < N) atomicMin(&key[q0 + tid], sbest[tid]);
}

__global__ void finish(const unsigned* __restrict__ key, const uint8_t* __restrict__ valid, int N,
                       int* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < N) out[i] = valid[i] ? (int)(key[i] & ((1u << IDX_BITS) - 1)) : -1;
}

extern "C" int assign_words_launch(const int* desc, const int* words, const uint8_t* valid, int N,
                                   int W, unsigned* key, int* out, cudaStream_t stream) {
    if (N == 0) return (int)cudaGetLastError();
    reset_keys<<<(N + NT - 1) / NT, NT, 0, stream>>>(key, N);
    if (W > 0) {
        dim3 grid((N + QB - 1) / QB, (W + WCHUNK - 1) / WCHUNK);
        assign_tile<<<grid, NT, 0, stream>>>(desc, words, N, W, key);
    }
    finish<<<(N + NT - 1) / NT, NT, 0, stream>>>(key, valid, N, out);
    return (int)cudaGetLastError();
}
