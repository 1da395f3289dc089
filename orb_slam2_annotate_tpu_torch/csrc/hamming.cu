// Bit-packed Hamming: (a) the batched, gate-fused matcher, (b) each map
// point's distinctive descriptor.
//
// Replaces (JAX reference): ops/matching.py match_masked with the candidate
// masks of window_mask / octave_mask / search_for_triangulation, over
// ops/hamming.py hamming_pairwise + masked_min2 (a); the descriptor half of
// worldmap/map_state.py _stats_from_table (:386-405): the gather of each
// point's observed descriptors, their vmapped pairwise Hamming distances,
// the sort, the median and the argmin (b).
//
// Bound of (a): the descriptors (64 B each), the gate inputs (a few words a
// row or column) and the outputs are the bytes; 16 XOR + popcount + add per
// gated pair are the operations.  No [N1,N2] tensor is read or written: the
// gate (validity, circular window + octave band, or epipolar distance) is
// evaluated per pair in registers.  At the main path's shapes (1024-4096
// rows x 1024 columns, B = 1-20) both are a few microseconds or less, so
// launches and host work decide the time: the design makes one launch per
// call, however many problems the call batches.
//
// Design (a), one launch: grid (row tiles, B).  A CTA takes ROWS query rows
// of one problem and streams that problem's desc2 through shared memory in
// tiles of NT columns, double-buffered with 16-byte cp.async (chunks
// XOR-swizzled so that the per-thread 64-byte column reads hit distinct
// banks); each desc2 word is read from L2 once per CTA, not once per row.
// Thread t owns column t of every tile: for each of the CTA's rows it
// evaluates the gate, counts bits with __popc, keeps a running
// (best, first index, second) per row in registers, and keeps the column's
// minimum over the CTA's rows of the packed key (dist << 32 | row) in a
// register, so there is one global atomicMin per column per CTA (and none
// where no row of the CTA is gated in).  Warp shuffles and one shared-memory
// step then merge the per-thread row states.  Finishing needs the column
// minima of the whole problem, which every CTA of it contributes: the last
// CTA of each problem to arrive (an atomic ticket taken after
// __threadfence(), the threadFenceReduction pattern) applies the distance
// gate, the ratio test and the column-min dedup or the mutual check to all
// rows of that problem, then resets the problem's column keys and ticket for
// the next call.  A cooperative launch with a grid-wide sync would need
// every CTA resident at once, which B = 20 problems of 64-128 CTAs each
// are not.  The workspace (column keys, row states, tickets) belongs to the
// device and is reused by every call on the stream.
//
// Bit for bit as the plain torch version (kernels/hamming.py): best is the
// first column on ties; second is the minimum over every other column
// (ties give second == best); ungated pairs read MAX_DIST = 512; the packed
// key gives the lowest row on ties.  Gate arithmetic is written in the plain
// version's order and compiled with --fmad=false, so a float compare decides
// the same bit in both.
//
// Bound of (b): bytes.  A point needs its max(cnt, 1) observed rows (64 B
// each, with their two indices), its count, and writes 68 bytes: at most
// ~2.4 KB, 9.7 MB at Q = 4096 with every count 32 (~3 us at 3.35 TB/s).
// The reference materialises the [Q,32,16] gather and the [Q,32,32]
// distances and sorts them; (b) keeps all of it on chip.
//
// Design (b), one warp a point, lane i for observation i: lane i loads row
// i straight from kf_desc through (obs_kf, obs_ft) into shared memory (rows
// padded to 20 words, so the fragment loads below hit 32 distinct banks)
// and counts its bits; the distances then reuse that buffer.  The 32 x 32
// AND-popcounts are 16 mma.sync.m16n8k256.b1.and.popc (2 row blocks x 4
// column blocks x 2 k-steps); d(i,j) = popc(i) + popc(j) - 2 popc(i AND j),
// and columns j >= cnt read 2048, as in the reference.  The distances go
// through shared memory so that lane i holds row i; it finds the element of
// rank k = (cnt-1)/2 of its first cnt distances bit by bit: the largest v
// below 1024 with at most k distances under v, 10 counts over the row
// (10 ceil(cnt/8) 8 compares; rows i >= cnt read 2048).  A warp minimum of
// med << 5 | i picks the first row of least median, as torch.argmin does
// (best = 0 when cnt = 0), and 16 lanes copy its row out (again from
// kf_desc, 64 bytes in L2).  Integer throughout: equal to the plain twin.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define WORDS 16
#define MAX_DIST 512
#define KEY_INIT (((unsigned long long)MAX_DIST) << 32)   // row 0 at MAX_DIST
#define NO_DIST (MAX_DIST + 1)                              // "no column yet"

enum { GATE_NONE = 0, GATE_WINDOW = 1, GATE_EPIPOLAR = 2, GATE_MASK = 3 };

// Field order and types mirror kernels/hamming.py:_MatchArgs.  Batch strides
// are in elements; 0 means the array is shared by every problem.  A null
// validity pointer means "all valid".
struct MatchArgs {
    const int* d1; const int* d2; const uint8_t* rv; const uint8_t* cv;
    long long s_d1, s_d2, s_rv, s_cv;
    // window: proj_xy [N1,2], radius [N1] (or rad_scalar when null),
    // pred_octave [N1]; shared with the epipolar gate: xy2 [N2,2], octave2 [N2]
    const float* pxy; const float* rad; const int* poct; const float* xy2; const int* oct2;
    long long s_pxy, s_rad, s_poct, s_xy2, s_oct2;
    float rad_scalar; int lo, hi, use_oct;
    // epipolar: F12 [3,3], xy1 [N1,2], inv_sigma2 [levels]
    const float* F; const float* xy1; const float* isig2;
    long long s_F, s_xy1;
    // dense mask [N1,N2]
    const uint8_t* mask; long long s_mask;
    int B, N1, N2, gate, max_dist, mutual;
    float ratio;
    unsigned long long* colkey;   // [B,N2], KEY_INIT between calls
    int* rowstate;                // [B,N1,3] best, first index, second
    unsigned int* ticket;         // [B], 0 between calls
    int* out;                     // [2,B,N1]: idx, then dist
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// 16-byte chunk p (0-3) of tile column c lives at chunk c*4 + (p ^ ((c>>1)&3))
__device__ __forceinline__ int chunk_slot(int c, int p) { return c * 4 + (p ^ ((c >> 1) & 3)); }

// merge (b, i, s) into (best, idx, second): lower distance, then lower index wins
__device__ __forceinline__ void merge(int& best, int& idx, int& second, int b, int i, int s) {
    if (b < best || (b == best && i < idx)) {
        second = min(s, best);
        best = b;
        idx = i;
    } else {
        second = min(second, b);
    }
}

template <int ROWS>
__global__ void __launch_bounds__(NT) hamming_match_fused(const MatchArgs a) {
    __shared__ __align__(16) int4 tile[2][NT * 4];
    __shared__ __align__(16) int q[ROWS][WORDS];
    __shared__ float rg[ROWS][4];                 // per-row gate terms
    __shared__ int ro[ROWS];                      // per-row predicted octave
    __shared__ int rok[ROWS];                     // row valid
    __shared__ int red[NT / 32][ROWS][3];
    __shared__ int any_row, is_last;

    const int b = blockIdx.y, r0 = blockIdx.x * ROWS, tid = threadIdx.x;
    const int N1 = a.N1, N2 = a.N2;
    const int nrows = min(ROWS, N1 - r0);
    const int* d2 = a.d2 + (size_t)b * a.s_d2;

    if (tid == 0) any_row = 0;
    __syncthreads();
    for (int k = tid; k < ROWS * WORDS; k += NT) {
        const int r = k / WORDS, w = k % WORDS;
        q[r][w] = r < nrows ? a.d1[(size_t)b * a.s_d1 + (size_t)(r0 + r) * WORDS + w] : 0;
    }
    if (tid < ROWS) {
        const int r = tid, i = r0 + r;
        int ok = r < nrows;
        if (ok && a.rv) ok = a.rv[(size_t)b * a.s_rv + i] != 0;
        rok[r] = ok;
        if (ok) atomicOr(&any_row, 1);
        float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f;
        int po = 0;
        if (ok && a.gate == GATE_WINDOW) {
            const float* p = a.pxy + (size_t)b * a.s_pxy + (size_t)i * 2;
            const float r_ = a.rad ? a.rad[(size_t)b * a.s_rad + i] : a.rad_scalar;
            g0 = p[0];
            g1 = p[1];
            g2 = r_ * r_;
            if (a.use_oct) po = a.poct[(size_t)b * a.s_poct + i];
        } else if (ok && a.gate == GATE_EPIPOLAR) {
            const float* F = a.F + (size_t)b * a.s_F;
            const float* p = a.xy1 + (size_t)b * a.s_xy1 + (size_t)i * 2;
            const float x = p[0], y = p[1];
            g0 = x * F[0] + y * F[3] + F[6];           // [x, y, 1] @ F12, term by term
            g1 = x * F[1] + y * F[4] + F[7];
            g2 = x * F[2] + y * F[5] + F[8];
            g3 = fmaxf(g0 * g0 + g1 * g1, 1e-12f);
        }
        rg[r][0] = g0; rg[r][1] = g1; rg[r][2] = g2; rg[r][3] = g3;
        ro[r] = po;
    }
    __syncthreads();

    int best[ROWS], bidx[ROWS], second[ROWS];
    if (!any_row) {
        // no row of this CTA is valid: every pair reads MAX_DIST, so each row's
        // best is MAX_DIST at column 0 and its second MAX_DIST
#pragma unroll
        for (int r = 0; r < ROWS; ++r) { best[r] = MAX_DIST; bidx[r] = 0; second[r] = MAX_DIST; }
    } else {
#pragma unroll
        for (int r = 0; r < ROWS; ++r) { best[r] = NO_DIST; bidx[r] = 0x7fffffff; second[r] = NO_DIST; }
        const int ntiles = (N2 + NT - 1) / NT;
        auto load_tile = [&](int t, int buf) {
            for (int k = tid; k < NT * 4; k += NT) {
                const int c = k >> 2, p = k & 3, j = t * NT + c;
                if (j < N2) cp_async16(&tile[buf][chunk_slot(c, p)], d2 + (size_t)j * WORDS + p * 4);
            }
        };
        load_tile(0, 0);
        cp_async_commit();
        for (int t = 0; t < ntiles; ++t) {
            if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
            cp_async_commit();
            cp_async_wait1();
            __syncthreads();
            const int j = t * NT + tid;
            if (j < N2) {
                int c[WORDS];
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    const int4 v = tile[t & 1][chunk_slot(tid, p)];
                    c[4 * p] = v.x; c[4 * p + 1] = v.y; c[4 * p + 2] = v.z; c[4 * p + 3] = v.w;
                }
                const bool cok = a.cv ? a.cv[(size_t)b * a.s_cv + j] != 0 : true;
                float x2 = 0.f, y2 = 0.f, thr = 0.f;
                int o2 = 0;
                if (a.gate == GATE_WINDOW || a.gate == GATE_EPIPOLAR) {
                    const float* p = a.xy2 + (size_t)b * a.s_xy2 + (size_t)j * 2;
                    x2 = p[0];
                    y2 = p[1];
                    if (a.gate == GATE_EPIPOLAR || a.use_oct) o2 = a.oct2[(size_t)b * a.s_oct2 + j];
                    if (a.gate == GATE_EPIPOLAR) thr = 3.84f * (1.0f / a.isig2[o2]);
                }
                const uint8_t* mcol = a.gate == GATE_MASK
                    ? a.mask + (size_t)b * a.s_mask + (size_t)r0 * N2 + j : nullptr;
                unsigned long long ckey = KEY_INIT;
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    bool g = rok[r] && cok;
                    if (g) {
                        if (a.gate == GATE_WINDOW) {
                            const float dx = rg[r][0] - x2, dy = rg[r][1] - y2;
                            g = dx * dx + dy * dy <= rg[r][2];
                            if (a.use_oct) g = g && o2 >= ro[r] + a.lo && o2 <= ro[r] + a.hi;
                        } else if (a.gate == GATE_EPIPOLAR) {
                            const float v = rg[r][0] * x2 + rg[r][1] * y2 + rg[r][2];
                            g = (v * v) / rg[r][3] < thr;
                        } else if (a.gate == GATE_MASK) {
                            g = mcol[(size_t)r * N2] != 0;
                        }
                    }
                    int d = MAX_DIST;
                    if (g) {
                        d = 0;
#pragma unroll
                        for (int w = 0; w < WORDS; ++w) d += __popc((unsigned)(q[r][w] ^ c[w]));
                        const unsigned long long key = (((unsigned long long)d) << 32) | (unsigned)(r0 + r);
                        ckey = key < ckey ? key : ckey;
                    }
                    // this thread's columns arrive in increasing order
                    if (d < best[r]) { second[r] = best[r]; best[r] = d; bidx[r] = j; }
                    else second[r] = min(second[r], d);
                }
                if (ckey < KEY_INIT) atomicMin(&a.colkey[(size_t)b * N2 + j], ckey);
            }
            __syncthreads();   // the next iteration's load_tile refills this buffer
        }
    }

    // merge the per-thread row states: warp shuffles, then across warps
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        for (int o = 16; o > 0; o >>= 1) {
            const int ob = __shfl_down_sync(0xffffffffu, best[r], o);
            const int oi = __shfl_down_sync(0xffffffffu, bidx[r], o);
            const int os = __shfl_down_sync(0xffffffffu, second[r], o);
            merge(best[r], bidx[r], second[r], ob, oi, os);
        }
        if (lane == 0) { red[warp][r][0] = best[r]; red[warp][r][1] = bidx[r]; red[warp][r][2] = second[r]; }
    }
    __syncthreads();
    if (tid < nrows) {
        int bb = red[0][tid][0], bi = red[0][tid][1], bs = red[0][tid][2];
        for (int w = 1; w < NT / 32; ++w) merge(bb, bi, bs, red[w][tid][0], red[w][tid][1], red[w][tid][2]);
        int* st = a.rowstate + ((size_t)b * N1 + r0 + tid) * 3;
        st[0] = bb;
        st[1] = bi;
        st[2] = min(bs, MAX_DIST);   // the plain version's second: MAX_DIST if no other column
    }

    // the last CTA of problem b finishes all its rows
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&a.ticket[b], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    int* idx_out = a.out + (size_t)b * N1;
    int* dist_out = a.out + (size_t)a.B * N1 + (size_t)b * N1;
    for (int i = tid; i < N1; i += NT) {
        const int* st = a.rowstate + ((size_t)b * N1 + i) * 3;
        const int bb = __ldcg(st), j = __ldcg(st + 1), bs = __ldcg(st + 2);
        bool ok = bb <= a.max_dist && (float)bb < a.ratio * (float)bs;
        if (ok) {
            const unsigned long long key = __ldcg(&a.colkey[(size_t)b * N2 + j]);
            if (a.mutual) ok = (int)(key & 0xffffffffull) == i;
            else ok = bb <= (int)(key >> 32);
        }
        idx_out[i] = ok ? j : -1;
        dist_out[i] = ok ? bb : MAX_DIST;
    }
    __syncthreads();
    for (int j = tid; j < N2; j += NT) a.colkey[(size_t)b * N2 + j] = KEY_INIT;
    if (tid == 0) a.ticket[b] = 0u;
}

#define DD_WARPS 4
#define DD_NT (DD_WARPS * 32)
#define MAX_OBS 32
#define ROW_WORDS 20      // a staged row: 16 words + 4 of padding
#define DIST_STRIDE 36    // a row of distances: 32 + 4 of padding; the rows, then
                          // the distances, share one buffer of 32 x 36 words
#define BIG 2048          // the reference's sentinel, > any distance
#define MED_BITS 10       // distances are 0..512 < 2^10

// D = popc(A AND B) + C for a 16x256 (row) by 256x8 (col) bit tile
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(DD_NT) distinctive_descriptors_kernel(
    const int* __restrict__ kf_desc, int K, int N, const int* __restrict__ obs_kf,
    const int* __restrict__ obs_ft, const int* __restrict__ obs_cnt, int Q,
    int* __restrict__ out_desc, int* __restrict__ out_best) {
    __shared__ __align__(16) int buf[DD_WARPS][MAX_OBS * DIST_STRIDE];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q = blockIdx.x * DD_WARPS + warp;
    if (q >= Q) return;                                  // the whole warp
    unsigned* rw = reinterpret_cast<unsigned*>(buf[warp]);
    int* dw = buf[warp];
    const int cnt = min(max(obs_cnt[q], 0), MAX_OBS);

    // stage row `lane` (indices clamped, as the reference's gather clamps)
    const int kf = min(max(obs_kf[(size_t)q * MAX_OBS + lane], 0), K - 1);
    const int ft = min(max(obs_ft[(size_t)q * MAX_OBS + lane], 0), N - 1);
    const size_t row = (size_t)kf * N + ft;
    const int4* src = reinterpret_cast<const int4*>(kf_desc + row * WORDS);
    int pc = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const int4 v = __ldg(src + p);
        reinterpret_cast<int4*>(rw + lane * ROW_WORDS)[p] = v;
        pc += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
    __syncwarp();

    // popc(i AND j) for all 32 x 32 pairs: lane (g, t) of each fragment
    // holds words t and t+4 of a row (A) or column (B) per 8-word k-step
    const int g = lane >> 2, t = lane & 3;
    int acc[2][4][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int w = 8 * s + t;
        unsigned a[2][4], b[4][2];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
            const unsigned* lo = rw + (16 * mb + g) * ROW_WORDS;
            const unsigned* hi = lo + 8 * ROW_WORDS;
            a[mb][0] = lo[w]; a[mb][1] = hi[w]; a[mb][2] = lo[w + 4]; a[mb][3] = hi[w + 4];
        }
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
            const unsigned* col = rw + (8 * nb + g) * ROW_WORDS;
            b[nb][0] = col[w];
            b[nb][1] = col[w + 4];
        }
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) mma_and_popc(acc[mb][nb], a[mb], b[nb][0], b[nb][1]);
    }
    __syncwarp();   // every fragment is read: the distances overwrite the rows
    // d = popc(i) + popc(j) - 2 popc(i AND j); lane (g, t) holds rows g, g+8
    // of each row block and columns 2t, 2t+1 of each column block
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = 16 * mb + g + 8 * h;
            const int pr = __shfl_sync(0xffffffffu, pc, r);
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
                const int c0 = 8 * nb + 2 * t;
                const int p0 = __shfl_sync(0xffffffffu, pc, c0);
                const int p1 = __shfl_sync(0xffffffffu, pc, c0 + 1);
                int2 d;
                d.x = c0 < cnt ? pr + p0 - 2 * acc[mb][nb][2 * h] : BIG;
                d.y = c0 + 1 < cnt ? pr + p1 - 2 * acc[mb][nb][2 * h + 1] : BIG;
                *reinterpret_cast<int2*>(dw + r * DIST_STRIDE + c0) = d;
            }
        }
    __syncwarp();

    // lane i: the element of rank k = (cnt-1)/2 of row i's first cnt
    // distances, the largest v with at most k of them below v, built from
    // the high bit down; each step counts in blocks of 8 up to cnt (cnt is
    // the same on every lane, and columns past cnt hold BIG, never below v)
    int med = BIG;
    if (lane < cnt) {
        int d[MAX_OBS];
#pragma unroll
        for (int p = 0; p < MAX_OBS / 4; ++p) {
            const int4 v = reinterpret_cast<const int4*>(dw + lane * DIST_STRIDE)[p];
            d[4 * p] = v.x; d[4 * p + 1] = v.y; d[4 * p + 2] = v.z; d[4 * p + 3] = v.w;
        }
        const int k = (cnt - 1) >> 1;
        int v = 0;
#pragma unroll
        for (int b = MED_BITS - 1; b >= 0; --b) {
            const int trial = v + (1 << b);
            int below = 0;
#pragma unroll
            for (int l0 = 0; l0 < MAX_OBS; l0 += 8) {
                if (l0 < cnt) {
#pragma unroll
                    for (int l = l0; l < l0 + 8; ++l) below += d[l] < trial;
                }
            }
            if (below <= k) v = trial;
        }
        med = v;
    }
    const int bkey = __reduce_min_sync(0xffffffffu, (med << 5) | lane);
    const int bi = bkey & 31;
    const size_t brow = __shfl_sync(0xffffffffu, row, bi);
    if (lane < WORDS) out_desc[(size_t)q * WORDS + lane] = __ldg(kf_desc + brow * WORDS + lane);
    if (lane == 0) out_best[q] = bi;
}

// Rows per CTA: 16 where that still gives at least two CTAs per SM of the
// H100's 132, else 8 (more CTAs, each re-reading desc2 from L2).
extern "C" int hamming_match_launch(const MatchArgs* a, cudaStream_t stream) {
    if (a->B == 0 || a->N1 == 0) return (int)cudaGetLastError();
    const long long ctas16 = (long long)((a->N1 + 15) / 16) * a->B;
    if (ctas16 >= 264) {
        dim3 grid((a->N1 + 15) / 16, a->B);
        hamming_match_fused<16><<<grid, NT, 0, stream>>>(*a);
    } else {
        dim3 grid((a->N1 + 7) / 8, a->B);
        hamming_match_fused<8><<<grid, NT, 0, stream>>>(*a);
    }
    return (int)cudaGetLastError();
}

extern "C" int distinctive_descriptors_launch(const int* kf_desc, int K, int N, const int* obs_kf,
                                              const int* obs_ft, const int* obs_cnt, int Q,
                                              int* out_desc, int* out_best, cudaStream_t stream) {
    if (Q > 0)
        distinctive_descriptors_kernel<<<(Q + DD_WARPS - 1) / DD_WARPS, DD_NT, 0, stream>>>(
            kf_desc, K, N, obs_kf, obs_ft, obs_cnt, Q, out_desc, out_best);
    return (int)cudaGetLastError();
}
