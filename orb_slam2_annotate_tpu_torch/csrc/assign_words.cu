// Kernel 5: nearest vocabulary word per descriptor (Hamming argmin), one
// launch, the distances on the 1-bit tensor cores.
//
// Replaces (JAX reference): worldmap/vocabulary.py assign_words (:81-86),
// i.e. ops/hamming.py hamming_pairwise(desc [N,16], words [W,16]) followed
// by the row argmin.  On the main path N = 1024 and W = 16384: 16.8M pairs
// of 512 bits, on every keyframe (BoW row of the database) and every
// relocalization attempt.
//
// Bound: operations.  8.6G AND + popcount bit pairs a call; no published
// rate exists for mma.sync on b1 operands, so the bound counts them at the
// int8 dense tensor rate, and the epilogue (a multiply-add and a minimum a
// pair) at the f32 rate.  The reference materializes the [N,W] distance
// matrix (64 MB); this kernel never writes it.
//
// Design: d(a,b) = popc(a) + popc(b) - 2 popc(a AND b).  popc(a) is the
// same for every word of a row, so the row's argmin is that of
// popc(b) - 2 popc(a AND b), and the row popcounts are never needed.  The
// AND-popcounts come from mma.sync.m16n8k256.b1.and.popc, two k-steps for
// the 512 bits.  A CTA of 4 warps takes 256 rows (64 a warp, as A fragments
// held in registers for the whole call) against a chunk of the vocabulary;
// the grid splits the vocabulary so that about two CTAs run on every SM.
// Vocabulary tiles of 128 words stream through shared memory with 16-byte
// cp.async, double-buffered, their 16-byte chunks XOR-swizzled so that the
// B-fragment loads (word t, t+4, t+8, t+12 of column g for lane (g, t)) hit
// 32 distinct banks.  When a tile lands, each thread packs one column's
// key base (popc(word) << 20 | word index), INT_MAX past W.  Each pair's
// epilogue is one multiply-add, base - (popc(a AND b) << 21) =
// (popc(b) - 2 popc(a AND b)) << 20 | word, and a signed minimum in
// registers: the minimum is the lowest word among equal distances
// (jnp.argmin's order), and a word past W never wins.  Shuffles combine
// the four lanes of a row, then one atomicMin per row per CTA reaches the
// per-device key workspace.  The last CTA of each row block (an atomic
// ticket taken after __threadfence()) unpacks the word, writes -1 where the
// row is not valid, and resets its keys and its ticket for the next call.
// All integer: equal to the plain torch twin bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NT 128
#define WARP_ROWS 64
#define CTA_ROWS (WARP_ROWS * NT / 32)
#define MB (WARP_ROWS / 16)
#define TILE 128
#define WORDS 16
#define IDX_BITS 20
#define FULL 0xffffffffu

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// 16-byte chunk p (0-3) of tile column c lives at chunk c*4 + (p ^ ((c>>1)&3))
__device__ __forceinline__ int chunk_slot(int c, int p) { return c * 4 + (p ^ ((c >> 1) & 3)); }

// D = popc(A AND B) + C for a 16x256 (row) by 256x8 (col) bit tile
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1, const int (&c)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

__global__ void __launch_bounds__(NT, 2) assign_words_b1(const int* __restrict__ desc,
                                                         const int* __restrict__ words,
                                                         const uint8_t* __restrict__ valid,
                                                         int N, int W, int chunk,
                                                         int* __restrict__ key,
                                                         unsigned* __restrict__ ticket,
                                                         int* __restrict__ out) {
    __shared__ __align__(16) int4 tile[2][TILE * 4];
    __shared__ int base[2][TILE];
    __shared__ int is_last;
    const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.x * CTA_ROWS + (tid >> 5) * WARP_ROWS;
    const int w0 = blockIdx.y * chunk, w1 = min(W, w0 + chunk);

    // A fragments of the warp's 64 rows: lane (g, t) holds words t and t+4 of
    // rows g and g+8 of each 16-row block, for k-steps 0 (words 0-7) and 1 (8-15)
    unsigned a[MB][2][4];
#pragma unroll
    for (int m = 0; m < MB; ++m) {
        const int r_lo = row0 + m * 16 + g, r_hi = r_lo + 8;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int c = 8 * s + t;
            a[m][s][0] = r_lo < N ? (unsigned)desc[(size_t)r_lo * WORDS + c] : 0u;
            a[m][s][1] = r_hi < N ? (unsigned)desc[(size_t)r_hi * WORDS + c] : 0u;
            a[m][s][2] = r_lo < N ? (unsigned)desc[(size_t)r_lo * WORDS + c + 4] : 0u;
            a[m][s][3] = r_hi < N ? (unsigned)desc[(size_t)r_hi * WORDS + c + 4] : 0u;
        }
    }
    int best[MB][2];
#pragma unroll
    for (int m = 0; m < MB; ++m) best[m][0] = best[m][1] = INT_MAX;

    const int ntiles = (w1 - w0 + TILE - 1) / TILE;
    auto load_tile = [&](int tt, int buf) {
        for (int k = tid; k < TILE * 4; k += NT) {
            const int c = k >> 2, p = k & 3, j = w0 + tt * TILE + c;
            if (j < w1) cp_async16(&tile[buf][chunk_slot(c, p)], words + (size_t)j * WORDS + p * 4);
            else tile[buf][chunk_slot(c, p)] = make_int4(0, 0, 0, 0);
        }
    };
    const int zero[4] = {0, 0, 0, 0};
    if (ntiles > 0) load_tile(0, 0);
    cp_async_commit();
    for (int tt = 0; tt < ntiles; ++tt) {
        const int buf = tt & 1;
        if (tt + 1 < ntiles) load_tile(tt + 1, buf ^ 1);
        cp_async_commit();
        cp_async_wait1();
        __syncthreads();
        for (int c = tid; c < TILE; c += NT) {
            const int j = w0 + tt * TILE + c;
            int pc = 0;
#pragma unroll
            for (int p = 0; p < 4; ++p) {
                const int4 v = tile[buf][chunk_slot(c, p)];
                pc += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
            }
            base[buf][c] = j < w1 ? (pc << IDX_BITS) | j : INT_MAX;
        }
        __syncthreads();
        const int* tw = reinterpret_cast<const int*>(tile[buf]);
#pragma unroll 4
        for (int nb = 0; nb < TILE / 8; ++nb) {
            const int col = nb * 8 + g;
            const unsigned b00 = tw[chunk_slot(col, 0) * 4 + t], b01 = tw[chunk_slot(col, 1) * 4 + t];
            const unsigned b10 = tw[chunk_slot(col, 2) * 4 + t], b11 = tw[chunk_slot(col, 3) * 4 + t];
            const int k0 = base[buf][nb * 8 + 2 * t], k1 = base[buf][nb * 8 + 2 * t + 1];
#pragma unroll
            for (int m = 0; m < MB; ++m) {
                int d0[4], d[4];
                mma_and_popc(d0, a[m][0], b00, b01, zero);
                mma_and_popc(d, a[m][1], b10, b11, d0);
                // lane (g, t) holds rows g (d[0], d[1]) and g+8 (d[2], d[3]),
                // columns 2t and 2t+1
                best[m][0] = min(best[m][0], min(k0 - (d[0] << (IDX_BITS + 1)),
                                                 k1 - (d[1] << (IDX_BITS + 1))));
                best[m][1] = min(best[m][1], min(k0 - (d[2] << (IDX_BITS + 1)),
                                                 k1 - (d[3] << (IDX_BITS + 1))));
            }
        }
        __syncthreads();   // the next iteration's load_tile refills the other buffer
    }

    // the four lanes of a row, then one atomicMin per row per CTA
#pragma unroll
    for (int m = 0; m < MB; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int v = best[m][h];
            v = min(v, __shfl_xor_sync(FULL, v, 1));
            v = min(v, __shfl_xor_sync(FULL, v, 2));
            const int r = row0 + m * 16 + g + 8 * h;
            if (t == 0 && r < N && v != INT_MAX) atomicMin(&key[r], v);
        }
    }

    // the last CTA of this row block finishes its rows
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&ticket[blockIdx.x], 1u) == gridDim.y - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    for (int i = tid; i < CTA_ROWS; i += NT) {
        const int r = blockIdx.x * CTA_ROWS + i;
        if (r < N) {
            const int k = __ldcg(&key[r]);
            out[r] = valid[r] ? (k & ((1 << IDX_BITS) - 1)) : -1;
            key[r] = INT_MAX;
        }
    }
    if (tid == 0) ticket[blockIdx.x] = 0u;
}

// key [>= N] holds INT_MAX and ticket [>= row blocks] 0 between calls.
extern "C" int assign_words_launch(const int* desc, const int* words, const uint8_t* valid, int N,
                                   int W, int* key, unsigned* ticket, int* out,
                                   cudaStream_t stream) {
    if (N == 0 || W == 0) return (int)cudaGetLastError();
    static int n_sm = 0;
    if (n_sm == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    }
    const int row_blocks = (N + CTA_ROWS - 1) / CTA_ROWS;
    // about two CTAs per SM: split the vocabulary into chunks of whole tiles
    const int want = (2 * n_sm + row_blocks - 1) / row_blocks;
    int chunk = (W + want - 1) / want;
    chunk = (chunk + TILE - 1) / TILE * TILE;
    dim3 grid(row_blocks, (W + chunk - 1) / chunk);
    assign_words_b1<<<grid, NT, 0, stream>>>(desc, words, valid, N, W, chunk, key, ticket, out);
    return (int)cudaGetLastError();
}
