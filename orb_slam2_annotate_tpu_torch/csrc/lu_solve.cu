// Kernel 12c: the distributed BA's reduced camera system (parallel/dist_ba.py
// on the card) solved by LU with partial pivoting, in the one order its CPU
// twin (kernels/lu_solve.py lu_solve_plain) takes, so the card gives the
// CPU's bits.
//
// Replaces (JAX reference): parallel/dist_ba.py's jnp.linalg.solve(Sf, rf)
// (:190), an LU as the reference's (not the dense BA's Cholesky: a system
// that is not positive definite still gives a step).
//
// The order, the same on both devices: at step k the pivot row p is the
// first row i >= k of largest |A_ik| (a NaN above every number, torch's
// argmax), rows k and p swap whole (the right-hand side with them); then
// L_ik = A_ik / A_kk and A_ij -= L_ik A_kj for i, j > k, each product
// rounded before its subtraction (--fmad=false).  So every entry is one chain
// of multiply-subtracts in ascending k, whatever the schedule; y_i = b_i -
// L_i0 y_0 - ... (ascending), x_i = (y_i - U_i,n-1 x_n-1 - ... - U_i,i+1
// x_i+1) / U_ii (descending).  A zero pivot divides by zero on both devices.
// y is the right-hand side carried as column n of the matrix: it swaps with
// the rows and takes L_ik y_k at step k, which is the twin's forward chain
// (the twin swaps b at each step, then subtracts in ascending k).
//
// The schedule: 32-column panels, one launch a panel, then one launch for
// the back solve.  Launch k (panel k, columns j0 = 32 k ..), CTAs of 1024
// threads:
//   the panel: G = ceil((n - j0) / 1024) CTAs (a thread block cluster when
//       G > 1), a thread a row of the panel's n - j0 rows, its 32 entries in
//       registers.  A column is: each warp's first largest |entry| by two
//       redux.sync (the key |a| + 1, a NaN above all; then the lowest row),
//       its row and the top row staged in shared memory, one barrier, every
//       warp reducing the warps' keys (and with G > 1 the CTAs' through
//       distributed shared memory behind a cluster barrier), then the swap
//       and each row's multiplier and terms in its registers; with G > 1 a
//       last cluster barrier after the last column, so no CTA exits while
//       another still reads its shared memory.  The rows' final places give
//       the panel's swaps as one list of (row, source) pairs.  From k = 1
//       the panel first waits (a counter in global memory) for the items of
//       its own column block;
//   items, columns of [j0, n] (2 each over the panel's own block, which come
//       first, then 8 each): panel k - 1's swaps on those columns (one gather
//       of the touched rows), U's 32 rows there (a warp a column, lane i's
//       chain over L_i0.. shuffled), then every row below (a thread a
//       (row, column), its L row as 16-byte loads, the terms in ascending
//       order).  Launch 0's items copy S and b.
// The roles go by the order in which the launch's clusters (of G CTAs) start,
// not by blockIdx: each takes a ticket from a counter, the clusters of the
// panel's own-block items the first ones, the panel's cluster the next.  So
// every item the panel waits for is already running when it waits, and items
// wait for nothing: the wait needs no co-residency of the launch's CTAs.
// So before launch k every entry holds its chain through column j0 - 32 and
// launch k adds the next 32 terms: no chain changes order.
//   lu_back (one CTA of 256 threads): the last panel's swaps and terms on y,
//       then U x = y by 32-row blocks from the last; warp 0 carries the chain
//       (block b + 1's terms on block b, then block b's 32 steps: a division,
//       a shuffle, a multiply-subtract each), its two 32 x 32 coefficient
//       tiles staged by warp 4 in a ring of shared memory up to four blocks
//       ahead; the helper threads (the warps off warp 0's scheduler) apply
//       each solved block's terms to every row two and more blocks below it
//       (descending), four rows a thread at a time, their coefficients loaded
//       before the block is solved.  Shared counters order them; no CTA
//       barrier.
// Bound: the dependency chain: n pivot searches and 2 n divisions in
// dependent order, ceil(n / 32) + 1 dependent launches; n^3 / 3
// multiply-subtracts (151 M at n = 768) are a few us of the card's float rate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define PB 32
#define THREADS 1024
#define NWARP (THREADS / 32)
#define BACK_THREADS 256
#define RING 4                 // the back solve's staged coefficient tiles
#define IC 8                   // an item's columns
#define IC_PANEL 2             // an item's columns in the panel's own block
#define MAX_G 12               // the panel's CTAs (a cluster of up to 12)
#define MAX_N (MAX_G * THREADS)
#define MAX_SWAPS (2 * PB)     // a panel's touched rows: its own 32 and their pivots
#define FULL 0xffffffffu

// a spin that outlasts SPIN_LIMIT_NS traps (a launch error) instead of holding the card
#define SPIN_LIMIT_NS 2000000000ull
__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// a / b correctly rounded; a zero dividend would take IEEE division's slow path (~4 x the
// fast one on this card), and for a finite nonzero b the product a * b is the same signed
// zero, so it takes that instead
__device__ __forceinline__ float div_rn(float a, float b) {
    if (a == 0.0f && b != 0.0f && fabsf(b) <= 3.402823466e38f) return a * b;
    return a / b;
}

// launch `kernel` on `stream`, as a cluster of `cluster` CTAs when above one
template <typename... Params, typename... Args>
static cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, int cluster, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    int na = 0;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    if (cluster > 1) {
        attr[na].id = cudaLaunchAttributeClusterDimension;
        attr[na].val.clusterDim.x = cluster;
        attr[na].val.clusterDim.y = 1;
        attr[na++].val.clusterDim.z = 1;
    }
    cfg.attrs = attr;
    cfg.numAttrs = na;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// the pivot key: |a| + 1 as bits (a NaN above every number), 0 for a row out of the search
__device__ __forceinline__ unsigned pivot_key(float v) {
    const float a = fabsf(v);
    return isnan(a) ? 0x7fc00001u : __float_as_uint(a) + 1u;
}

__device__ __forceinline__ int row_stride(int n) { return (n + 4) & ~3; }

struct Panel {                       // one CTA's shared state for the column steps
    __align__(16) float wrow[2][NWARP][PB];   // each warp's candidate row, by column parity
    unsigned wkey[2][NWARP];
    int wpos[2][NWARP], worg[2][NWARP];
    __align__(16) float jrow[2][PB];  // the top row (CTA 0)
    int jorg[2];
    unsigned ckey[2];                // the CTA's best (G > 1)
    int cpos[2], cwarp[2];
    __align__(16) float ubuf[2][PB];  // the winner's and the top row, copied in (G > 1)
    __align__(16) float jbuf[2][PB];
    int uorg[2], jorg_in[2], gpos[2];
};

struct Item {
    float G[MAX_SWAPS][IC];          // the touched rows' sources
    float Ls[PB][PB + 1];            // panel k - 1's unit lower block
    float us[PB][IC];                // U's rows in this item's columns
};

// launch k's items: ceil(min(32, n + 1 - 32 k) / IC_PANEL) of IC_PANEL columns over
// the panel's own block (k > 0; its panel waits for them), then IC columns at a time
__host__ __device__ __forceinline__ int panel_items(int n, int k) {
    return k == 0 ? 0 : (min(PB, n + 1 - k * PB) + IC_PANEL - 1) / IC_PANEL;
}
__host__ __device__ __forceinline__ int rest_begin(int n, int k) {
    return k == 0 ? min(PB, n) : min(n + 1, (k + 1) * PB);
}

__device__ void lu_panel(const float* __restrict__ S, float* A, int n, int k, int G, int rank,
                         int nk, int* cnt, int* nsw, int2* sw, Panel& P) {
    const int ld = row_stride(n), tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int j0 = k * PB, w = min(PB, n - j0), m = n - j0;
    const int pos = rank * THREADS + tid;   // rank: the CTA's place in the panel's cluster
    const bool live = pos < m;
    if (k > 0) {                      // the items of this column block
        if (tid == 0) {
            const unsigned long long t0 = now_ns();
            while (*(volatile int*)&cnt[k] < nk)
                if (now_ns() - t0 > SPIN_LIMIT_NS) __trap();
            __threadfence();
        }
        __syncthreads();
    }
    float a[PB];
    int org = pos;
    if (live && k > 0) {             // the row's 32 entries as 8 aligned 16-byte loads
        const float4* src = reinterpret_cast<const float4*>(&A[(size_t)(j0 + pos) * ld + j0]);
#pragma unroll
        for (int q = 0; q < PB / 4; ++q) {
            const float4 v = __ldcg(&src[q]);
            a[4 * q] = v.x;
            a[4 * q + 1] = v.y;
            a[4 * q + 2] = v.z;
            a[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < PB; ++c) a[c] = c < w ? a[c] : 0.0f;
    } else {
#pragma unroll
        for (int c = 0; c < PB; ++c) a[c] = live && c < w ? S[(size_t)pos * n + c] : 0.0f;
    }
#pragma unroll
    for (int jj = 0; jj < PB; ++jj) {
        if (jj >= w) break;
        const int par = jj & 1;
        const unsigned key = live && pos >= jj ? pivot_key(a[jj]) : 0u;
        const unsigned wk = __reduce_max_sync(FULL, key);
        const int wp = __reduce_min_sync(FULL, key == wk ? pos : INT_MAX);
        if (wk != 0u && pos == wp) {
            float4* d = reinterpret_cast<float4*>(P.wrow[par][wid]);
#pragma unroll
            for (int q = 0; q < PB / 4; ++q)
                d[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
            P.worg[par][wid] = org;
        }
        if (lane == 0) {
            P.wkey[par][wid] = wk;
            P.wpos[par][wid] = wp;
        }
        if (pos == jj) {
            float4* d = reinterpret_cast<float4*>(P.jrow[par]);
#pragma unroll
            for (int q = 0; q < PB / 4; ++q)
                d[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
            P.jorg[par] = org;
        }
        __syncthreads();
        const unsigned kk = P.wkey[par][lane];
        const unsigned ck = __reduce_max_sync(FULL, kk);
        int p = __reduce_min_sync(FULL, kk == ck ? P.wpos[par][lane] : INT_MAX);
        const float* u;
        const float* jr;
        int uo, jo;
        if (G == 1) {
            const int cw = p >> 5;
            u = P.wrow[par][cw];
            uo = P.worg[par][cw];
            jr = P.jrow[par];
            jo = P.jorg[par];
        } else {
            cg::cluster_group cl = cg::this_cluster();
            if (tid == 0) {
                P.ckey[par] = ck;
                P.cpos[par] = p;
                P.cwarp[par] = (p & (THREADS - 1)) >> 5;
            }
            cl.sync();
            if (wid < 2) {
                const unsigned rk = lane < G ? *cl.map_shared_rank(&P.ckey[par], lane) : 0u;
                const unsigned bk = __reduce_max_sync(FULL, rk);
                p = __reduce_min_sync(FULL, lane < G && rk == bk
                                                ? *cl.map_shared_rank(&P.cpos[par], lane)
                                                : INT_MAX);
                const int gw = p / THREADS;
                if (wid == 0) {
                    const int cw = *cl.map_shared_rank(&P.cwarp[par], gw);
                    P.ubuf[par][lane] = cl.map_shared_rank(&P.wrow[par][cw][0], gw)[lane];
                    if (lane == 0) P.uorg[par] = *cl.map_shared_rank(&P.worg[par][cw], gw);
                } else {
                    P.jbuf[par][lane] = cl.map_shared_rank(&P.jrow[par][0], 0)[lane];
                    if (lane == 0) P.jorg_in[par] = *cl.map_shared_rank(&P.jorg[par], 0);
                }
                if (lane == 0 && wid == 0) P.gpos[par] = p;
            }
            __syncthreads();
            p = P.gpos[par];
            u = P.ubuf[par];
            uo = P.uorg[par];
            jr = P.jbuf[par];
            jo = P.jorg_in[par];
        }
        // the swap: row jj takes the pivot row, the pivot's place the old row jj
        if (pos == jj) {
#pragma unroll
            for (int c = 0; c < PB; ++c) a[c] = u[c];
            org = uo;
        } else if (pos == p) {
#pragma unroll
            for (int c = 0; c < PB; ++c) a[c] = jr[c];
            org = jo;
        }
        // the rows below: the multiplier, then its terms on the panel's later columns
        if (live && pos > jj) {
            const float l = div_rn(a[jj], u[jj]);
            a[jj] = l;
#pragma unroll
            for (int q = (jj + 1) / 4; q < PB / 4; ++q) {
                const float4 u4 = reinterpret_cast<const float4*>(u)[q];
                const float uv[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (4 * q + e > jj) a[4 * q + e] -= l * uv[e];
            }
        }
    }
    // the last column's reads of the other CTAs' shared memory end before any CTA exits
    if (G > 1) cg::this_cluster().sync();
    if (live) {
        float* dst = &A[(size_t)(j0 + pos) * ld + j0];
        if (w == PB) {
#pragma unroll
            for (int q = 0; q < PB / 4; ++q)
                __stcg(reinterpret_cast<float4*>(dst) + q,
                       make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]));
        } else {
#pragma unroll
            for (int c = 0; c < PB; ++c)
                if (c < w) __stcg(dst + c, a[c]);
        }
        if (org != pos) {
            const int s = atomicAdd(&nsw[k], 1);
            sw[k * MAX_SWAPS + s] = make_int2(j0 + pos, j0 + org);
        }
    }
}

__device__ void lu_item(const float* __restrict__ S, const float* __restrict__ b, float* A,
                        int n, int k, int it, int nk, int* cnt, const int* nsw, const int2* sw,
                        Item& I) {
    const int ld = row_stride(n), tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int tw = it < nk ? IC_PANEL : IC;   // columns an item, threads a row
    const int c0 = it < nk ? k * PB + IC_PANEL * it : rest_begin(n, k) + IC * (it - nk);
    const int nc = min(tw, n + 1 - c0);
    const int c = tid % tw, rstep = THREADS / tw;
    if (k == 0) {                     // copy S and b
        for (int r = tid / tw; r < n; r += rstep)
            if (c < nc) A[(size_t)r * ld + c0 + c] = c0 + c < n ? S[(size_t)r * n + c0 + c] : b[r];
        return;
    }
    const int j0p = (k - 1) * PB;
    // panel k - 1's swaps on these columns: read every source, then write
    const int ns = nsw[k - 1];
    const int2* pairs = sw + (k - 1) * MAX_SWAPS;
    if (tid < ns * nc) I.G[tid / nc][tid % nc] = __ldcg(&A[(size_t)pairs[tid / nc].y * ld + c0 + tid % nc]);
    for (int q = tid; q < PB * PB; q += THREADS)
        I.Ls[q / PB][q % PB] = __ldg(&A[(size_t)(j0p + q / PB) * ld + j0p + q % PB]);
    __syncthreads();
    if (tid < ns * nc) __stcg(&A[(size_t)pairs[tid / nc].x * ld + c0 + tid % nc], I.G[tid / nc][tid % nc]);
    __syncthreads();
    // U's rows: warp c takes column c0 + c, lane i row j0p + i
    if (wid < nc) {
        float* pa = &A[(size_t)(j0p + lane) * ld + c0 + wid];
        float v = __ldcg(pa);
#pragma unroll
        for (int mm = 0; mm < PB; ++mm) {
            const float um = __shfl_sync(FULL, v, mm);
            if (lane > mm) v -= I.Ls[lane][mm] * um;
        }
        __stcg(pa, v);
        I.us[lane][wid] = v;
    } else if (wid < IC) {
        I.us[lane][wid] = 0.0f;
    }
    __syncthreads();
    // the rows below: tw threads a row, a column each (a warp reads 32 / tw rows' runs of
    // tw columns), the row's 32 L entries as 16-byte loads, the terms in ascending order
    float uc[PB];
#pragma unroll
    for (int mm = 0; mm < PB; ++mm) uc[mm] = I.us[mm][c];
    for (int r = j0p + PB + tid / tw; r < n; r += rstep) {
        float acc = c < nc ? __ldcg(&A[(size_t)r * ld + c0 + c]) : 0.0f;
        const float4* Lr = reinterpret_cast<const float4*>(&A[(size_t)r * ld + j0p]);
#pragma unroll
        for (int q = 0; q < PB / 4; ++q) {
            const float4 l4 = __ldg(&Lr[q]);
            acc -= l4.x * uc[4 * q];
            acc -= l4.y * uc[4 * q + 1];
            acc -= l4.z * uc[4 * q + 2];
            acc -= l4.w * uc[4 * q + 3];
        }
        if (c < nc) __stcg(&A[(size_t)r * ld + c0 + c], acc);
    }
    if (it < nk) {                    // the panel of this launch waits for these
        __threadfence();
        __syncthreads();
        if (tid == 0) atomicAdd(&cnt[k], 1);
    }
}

__global__ void __launch_bounds__(THREADS, 1) lu_step(const float* __restrict__ S,
                                                      const float* __restrict__ b, float* A,
                                                      int n, int k, int G, int nitems, int nk,
                                                      int* cnt, int* tick, int* nsw, int2* sw) {
    extern __shared__ __align__(16) unsigned char smem[];   // a Panel or an Item
    __shared__ int s_ticket;
    // the cluster's ticket: its place in the order the launch's clusters start
    int rank = 0, t;
    if (G == 1) {
        if (threadIdx.x == 0) s_ticket = atomicAdd(&tick[k], 1);
        __syncthreads();
        t = s_ticket;
    } else {
        cg::cluster_group cl = cg::this_cluster();
        rank = (int)cl.block_rank();
        if (rank == 0 && threadIdx.x == 0) s_ticket = atomicAdd(&tick[k], 1);
        cl.sync();
        t = *cl.map_shared_rank(&s_ticket, 0);
        cl.sync();                    // read by every CTA before rank 0 may exit
    }
    const int npre = (nk + G - 1) / G;   // the clusters of the panel's own-block items
    if (t == npre) {
        lu_panel(S, A, n, k, G, rank, nk, cnt, nsw, sw, *reinterpret_cast<Panel*>(smem));
    } else {
        const int it = (t < npre ? t : t - 1) * G + rank;
        if (it < nitems) lu_item(S, b, A, n, k, it, nk, cnt, nsw, sw, *reinterpret_cast<Item*>(smem));
    }
}

// the last panel's swaps and terms on y, then U x = y by 32-row blocks from the
// last: warp 0 carries the chain (block b + 1's terms on block b, then block b's own),
// the helper threads (the warps off warp 0's scheduler) apply each solved block's terms
// to every row two and more blocks below it, four rows a thread at a time with their
// coefficients loaded before the block is solved; the shared counters `solved` and
// `hdone` (helper warps done with a block's terms) order them, no CTA barrier
__global__ void __launch_bounds__(BACK_THREADS) lu_back(const float* A, int n, const int* nsw,
                                                        const int2* sw, float* x) {
    extern __shared__ __align__(16) float v[];    // [n rounded up to 32]: y, then x; 0 past n
    __shared__ volatile int solved;               // blocks solved, from the last
    __shared__ int hdone[MAX_N / PB];             // helper warps done with block K's terms
    __shared__ float tile[RING][2][PB][PB + 1];   // block b's own tile and its next block's
    __shared__ volatile int ready[RING];          // the block each slot holds
    __shared__ float moved[MAX_SWAPS];
    const int ld = row_stride(n), tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    // helpers: the warps off warp 0's scheduler (warps 4k share it and stay idle)
    const int NHW = BACK_THREADS / 32 - BACK_THREADS / 128, NHT = 32 * NHW;
    const int nb = (n + PB - 1) / PB, kl = nb - 1, j0 = kl * PB, w = n - j0;
    for (int i = tid; i < nb * PB; i += BACK_THREADS) v[i] = i < n ? A[(size_t)i * ld + n] : 0.0f;
    for (int bb = tid; bb < nb; bb += BACK_THREADS) hdone[bb] = 0;
    if (tid == 0) solved = 0;
    if (tid < RING) ready[tid] = -1;
    __syncthreads();
    const int ns = nsw[kl];
    if (tid < ns) moved[tid] = v[sw[kl * MAX_SWAPS + tid].y];
    __syncthreads();
    if (tid < ns) v[sw[kl * MAX_SWAPS + tid].x] = moved[tid];
    __syncthreads();
    // a row's 32 entries of U from column c0 (16-byte aligned): rows past n read nothing
    auto row32 = [&](int i, int c0, float* out) {
        if (i < n) {
            const float4* src = reinterpret_cast<const float4*>(A + (size_t)i * ld + c0);
#pragma unroll
            for (int q = 0; q < PB / 4; ++q) {
                const float4 u4 = src[q];
                out[4 * q] = u4.x;
                out[4 * q + 1] = u4.y;
                out[4 * q + 2] = u4.z;
                out[4 * q + 3] = u4.w;
            }
        } else {
#pragma unroll
            for (int q = 0; q < PB; ++q) out[q] = 0.0f;
        }
    };
    if (wid == 0) {
        {   // the last panel's terms on y (its rows have no rows below)
            float a = lane < w ? v[j0 + lane] : 0.0f;
            float lr[PB];
            row32(j0 + lane, j0, lr);
#pragma unroll
            for (int mm = 0; mm < PB; ++mm) {
                if (mm < w) {
                    const float ym = __shfl_sync(FULL, a, mm);
                    if (lane > mm && lane < w) a -= lr[mm] * ym;
                }
            }
            if (lane < w) v[j0 + lane] = a;
            __syncwarp();
        }
        for (int b = nb - 1; b >= 0; --b) {
            const int b0 = b * PB, wb = min(PB, n - b0), i = b0 + lane, slot = b % RING;
            const int K0 = b0 + PB, wK = b + 1 < nb ? min(PB, n - K0) : 0;
            // block b's tiles staged (warp 4) and the helpers' terms of blocks >= b + 2
            if (ready[slot] != b || (b + 2 < nb && *(volatile int*)&hdone[b + 2] < NHW)) {
                const unsigned long long t0 = now_ns();
                while (ready[slot] != b || (b + 2 < nb && *(volatile int*)&hdone[b + 2] < NHW))
                    if (now_ns() - t0 > SPIN_LIMIT_NS) __trap();
            }
            __threadfence_block();
            // block b's own coefficients (cf), its diagonal (dd: every lane all 32) and
            // block b + 1's terms (tm)
            float cf[PB], tm[PB], dd[PB];
#pragma unroll
            for (int jj = 0; jj < PB; ++jj) {
                cf[jj] = tile[slot][0][lane][jj];
                tm[jj] = tile[slot][1][lane][jj];
                dd[jj] = tile[slot][0][jj][jj];
            }
            float acc = v[i];         // past n: 0
            if (wK > 0) {
                float xk[PB];         // block b + 1's x, read at once
#pragma unroll
                for (int q = 0; q < PB / 4; ++q) {
                    const float4 x4 = reinterpret_cast<const float4*>(v + K0)[q];
                    xk[4 * q] = x4.x;
                    xk[4 * q + 1] = x4.y;
                    xk[4 * q + 2] = x4.z;
                    xk[4 * q + 3] = x4.w;
                }
#pragma unroll
                for (int m = PB - 1; m >= 0; --m)
                    if (m < wK) acc -= tm[m] * xk[m];
            }
            // x_jj = acc_jj / d_jj, every lane dividing lane jj's dividend (one path for
            // the warp), then its term in the rows above (lanes and steps past wb compute
            // what no row reads)
#pragma unroll
            for (int jj = PB - 1; jj >= 0; --jj) {
                const float xj = div_rn(__shfl_sync(FULL, acc, jj), dd[jj]);
                acc = lane == jj ? xj : (lane < jj && jj < wb ? acc - cf[jj] * xj : acc);
            }
            if (lane < wb) v[i] = acc;
            __syncwarp();
            __threadfence_block();
            solved = nb - b;
        }
    } else if (wid == 4) {
        // the stager: block b's two tiles into ring slot b mod RING, once block b + RING
        // (the slot's last user) is solved; a row of a tile a coalesced load
        for (int b = nb - 1; b >= 0; --b) {
            const int b0 = b * PB, slot = b % RING;
            if (b + RING < nb && solved < nb - (b + RING)) {
                const unsigned long long t0 = now_ns();
                while (solved < nb - (b + RING))
                    if (now_ns() - t0 > SPIN_LIMIT_NS) __trap();
            }
            __threadfence_block();
            float t0r[PB], t1r[PB];
#pragma unroll
            for (int r = 0; r < PB; ++r) {
                t0r[r] = A[(size_t)min(b0 + r, n - 1) * ld + min(b0 + lane, ld - 1)];
                t1r[r] = A[(size_t)min(b0 + r, n - 1) * ld + min(b0 + PB + lane, ld - 1)];
            }
#pragma unroll
            for (int r = 0; r < PB; ++r) {
                tile[slot][0][r][lane] = t0r[r];
                tile[slot][1][r][lane] = t1r[r];
            }
            __syncwarp();
            __threadfence_block();
            ready[slot] = b;
        }
    } else if ((wid & 3) != 0) {
        const int ht = 32 * (wid - 1 - (wid >> 2)) + lane;
        constexpr int R = 4;                      // rows a thread at a time
        for (int K = nb - 1; K >= 2; --K) {
            const int K0 = K * PB, wK = min(PB, n - K0), lim = K0 - PB;   // blocks <= K - 2
            float c[R][PB];
            auto fetch = [&](int i0) {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int i = i0 + r * NHT;
                    if (i < lim) {
                        const float4* src = reinterpret_cast<const float4*>(A + (size_t)i * ld + K0);
#pragma unroll
                        for (int q = 0; q < PB / 4; ++q) {
                            const float4 u4 = src[q];
                            c[r][4 * q] = u4.x;
                            c[r][4 * q + 1] = u4.y;
                            c[r][4 * q + 2] = u4.z;
                            c[r][4 * q + 3] = u4.w;
                        }
                    }
                }
            };
            fetch(ht);
            if (*(volatile int*)&solved < nb - K) {
                const unsigned long long t0 = now_ns();
                while (*(volatile int*)&solved < nb - K)
                    if (now_ns() - t0 > SPIN_LIMIT_NS) __trap();
            }
            __threadfence_block();
            float xk[PB];             // block K's x (past n: 0; those terms are skipped)
#pragma unroll
            for (int q = 0; q < PB / 4; ++q) {
                const float4 x4 = reinterpret_cast<const float4*>(v + K0)[q];
                xk[4 * q] = x4.x;
                xk[4 * q + 1] = x4.y;
                xk[4 * q + 2] = x4.z;
                xk[4 * q + 3] = x4.w;
            }
            for (int i0 = ht; i0 < lim; i0 += R * NHT) {
                float acc[R];
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r] = i0 + r * NHT < lim ? v[i0 + r * NHT] : 0.0f;
#pragma unroll
                for (int mm = PB - 1; mm >= 0; --mm)
                    if (mm < wK)
#pragma unroll
                        for (int r = 0; r < R; ++r) acc[r] -= c[r][mm] * xk[mm];
#pragma unroll
                for (int r = 0; r < R; ++r)
                    if (i0 + r * NHT < lim) v[i0 + r * NHT] = acc[r];
                if (i0 + R * NHT < lim) fetch(i0 + R * NHT);
            }
            __syncwarp();
            __threadfence_block();
            if (lane == 0) atomicAdd(&hdone[K], 1);
        }
    }
    __syncthreads();
    for (int i = tid; i < n; i += BACK_THREADS) x[i] = v[i];
}

static const size_t STEP_SMEM = sizeof(Panel) > sizeof(Item) ? sizeof(Panel) : sizeof(Item);

// the kernels' attributes, once a process (outside any stream capture)
static cudaError_t set_attributes() {
    static bool attrs_set = false;
    if (attrs_set) return cudaSuccess;
    cudaError_t e = cudaFuncSetAttribute(lu_step, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(lu_step, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)STEP_SMEM);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(lu_back, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(MAX_N * sizeof(float)));
    if (e == cudaSuccess) attrs_set = true;
    return e;
}

// floats of workspace a solve of size n takes: the factors (n rows of stride
// row_stride(n), column n for y), then ints: ceil(n / 32) item counters,
// ceil(n / 32) swap counts and ceil(n / 32) tickets (each list rounded up to
// an even length) and ceil(n / 32) x 64 (row, source) pairs
extern "C" long long lu_solve_work_floats(int n) {
    const long long nb = (n + PB - 1) / PB, nbp = (nb + 1) & ~1ll;
    return (long long)n * ((n + 4) & ~3) + 3 * nbp + 2 * MAX_SWAPS * nb;
}

// clusters of lu_step that the card can hold at once when the panel of a system of
// size n spans G = ceil(n / 1024) CTAs (cudaOccupancyMaxActiveClusters); a negative
// cudaError_t where the query fails
extern "C" int lu_solve_max_clusters(int n) {
    if (n < 1 || n > MAX_N) return -(int)cudaErrorInvalidValue;
    cudaError_t e = set_attributes();
    if (e != cudaSuccess) return -(int)e;
    const int G = (n + THREADS - 1) / THREADS;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = dim3(G);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = STEP_SMEM;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, lu_step, &cfg);
    return e == cudaSuccess ? clusters : -(int)e;
}

// x = S^-1 b for S [n][n]; `work` holds lu_solve_work_floats(n) floats.
// Returns a cudaError_t (the first failing call's stops the rest).
extern "C" int lu_solve_launch(const float* S, const float* b, int n, float* work, float* x,
                               cudaStream_t stream) {
    if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
    cudaError_t e = set_attributes();
    if (e != cudaSuccess) return (int)e;
    const int nb = (n + PB - 1) / PB, nbp = (nb + 1) & ~1, ld = (n + 4) & ~3;
    float* A = work;
    int* cnt = reinterpret_cast<int*>(work + (size_t)n * ld);
    int* nsw = cnt + nbp;
    int* tick = nsw + nbp;
    int2* sw = reinterpret_cast<int2*>(tick + nbp);
    if ((reinterpret_cast<uintptr_t>(sw) & 7) != 0) return (int)cudaErrorMisalignedAddress;
    e = cudaMemsetAsync(cnt, 0, 3 * nbp * sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
    for (int k = 0; k < nb; ++k) {
        const int j0 = k * PB, G = (n - j0 + THREADS - 1) / THREADS;
        const int nk = panel_items(n, k);
        const int nitems = nk + (n + 1 - rest_begin(n, k) + IC - 1) / IC;
        const int grid = (G + nitems + G - 1) / G * G;
        e = launch(lu_step, dim3(grid), THREADS, STEP_SMEM, stream, G, S, b, A, n, k, G,
                   nitems, nk, cnt, tick, nsw, sw);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)launch(lu_back, dim3(1), BACK_THREADS, (size_t)nb * PB * sizeof(float), stream, 1,
                       (const float*)A, n, (const int*)nsw, (const int2*)sw, x);
}
