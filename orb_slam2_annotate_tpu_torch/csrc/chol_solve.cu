// Kernel 12b: the dense BA's reduced camera system (ba_core._cholesky_solve
// on the card) factored by Cholesky and solved, in the one order its CPU twin
// (kernels/chol_solve.py chol_solve_plain) takes, so the card gives the
// CPU's bits.
//
// Replaces (JAX reference): solvers/ba_core.py schur_solve_dense's
// jax.scipy.linalg.solve(Sf, rf, assume_a="pos") (:205).
//
// Every entry is one chain, the same on both devices:
//   L_ij = (S_ij - L_i0 L_j0 - L_i1 L_j1 - ... - L_i,j-1 L_j,j-1) / L_jj  (i > j),
//   L_jj = sqrt(S_jj - L_j0 L_j0 - ... - L_j,j-1 L_j,j-1),
//   y_j  = (r_j - y_0 L_j0 - ... - y_j-1 L_j,j-1) / L_jj,
//   x_i  = (y_i - L_n-1,i x_n-1 - ... - L_i+1,i x_i+1) / L_ii   (k descending),
// each product rounded before its subtraction (--fmad=false), IEEE square
// roots (sqrtf of a float is the float64 root rounded once) and divisions.
// y_j's chain is L_nj's for a row n = r^T appended to S (a product's
// operands commute exactly), so the forward solve is that row of the
// factor.  The step is all NaN where a pivot is not > 0 (the reference's
// solve refused), so it is never taken.
//
// The schedule: the augmented (n + 1) x n lower factor right-looking by
// 32-column panels, one launch a panel, then one launch for the back solve.
// Launch k (panel k, columns j0 = 32 k .. j0 + w - 1), CTAs of 256 threads:
//   panel CTAs, a 32-row tile of the rows below the panel's diagonal block
//       each (row n among them): each brings the diagonal block up to date
//       with panel k - 1 (32 terms an entry, ascending), then warp 0 factors
//       it, a lane a row, no CTA barrier a column: column jj's pivot is
//       shuffled to every lane, each takes its square root and divides (the
//       next pivot, lane jj + 1's own term, shuffled first), the column goes
//       to shared memory for the later columns' terms and, every four
//       columns, to warp 1 through a counter; meanwhile the warps off warp
//       0's scheduler bring the tile up to date, and warp 1 solves the
//       tile's rows against the factor (a thread a row, the same terms,
//       ascending) four columns behind; the block is padded with the
//       identity past w, so no step branches;
//   worker CTAs, a 32 x 32 tile of every later column block's lower part
//       each: its 32 terms of panel k - 1 (ascending), written back (launch
//       0 copies S's lower triangle and r instead).
// So before launch k an entry holds its chain through column j0 - 32 and
// launch k adds the next 32 terms: every chain keeps its order.  A panel's
// critical path is one 32-term update, one warp-serial 32-column
// factorization and the row solve's last four columns, with the rest of the
// update on the other SMs in the same launch.
//   chol_back (one CTA of 256 threads): x from L^T x = y by 32-row blocks
//       from the last; warp 0 carries the chain (block b + 1's terms on block
//       b, then block b's 32 steps: a division, a shuffle, a multiply-subtract
//       each), its two 32 x 32 coefficient tiles staged by warp 4 in a ring
//       of shared memory up to four blocks ahead; the helper threads (the
//       warps off warp 0's scheduler) apply each solved block's terms to
//       every row two and more blocks below it (descending), four rows a
//       thread at a time, their coefficients loaded before the block is
//       solved.  Shared counters order them; no CTA barrier.
// Bound: the dependency chain: n square roots and 2 n divisions in
// dependent order, ceil(n / 32) + 1 dependent launches; n^3 / 6
// multiply-subtracts (75 M at n = 768) are ~2 us of the card's float rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PB 32
#define THREADS 256
#define WARPS (THREADS / 32)
#define BACK_THREADS 256
#define RING 4                 // the back solve's staged coefficient tiles
#define FULL 0xffffffffu
#define MAX_N 12288            // x of chol_back in 48 KB of shared memory

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

// entry (i, j) of the augmented matrix before any term: S's lower triangle, r as row n
__device__ __forceinline__ float source(const float* __restrict__ S, const float* __restrict__ r,
                                        int n, int i, int j) {
    return i < n ? S[(size_t)i * n + j] : r[j];
}

// 32 terms of panel k - 1 on tile rows y0, y0 + ystep, ..: entry (y, x) -= R[y][m] C[x][m],
// m ascending (R: the rows' L entries in those columns, C: the tile columns' rows')
__device__ __forceinline__ void tile_terms(float (*T)[PB + 1], const float (*R)[PB + 1],
                                           const float (*C)[PB + 1], int x, int y0, int ystep) {
    for (int y = y0; y < PB; y += ystep) {
        float a = T[y][x];
#pragma unroll
        for (int m = 0; m < PB; ++m) a -= R[y][m] * C[x][m];
        T[y][x] = a;
    }
}

__global__ void __launch_bounds__(THREADS) chol_panel(const float* __restrict__ S,
                                                      const float* __restrict__ r, float* A,
                                                      int n, int k, int npanel, int* fail) {
    __shared__ float D[PB][PB + 1];     // the diagonal block, identity past w; then its factor
    __shared__ __align__(16) float Dt[PB][PB];   // the factor a column a row: Dt[j][i] = L_ij
    __shared__ float T[PB][PB + 1];     // this CTA's tile
    __shared__ float LD[PB][PB + 1];    // panel k - 1's columns of the diagonal block's rows
    __shared__ float LT[PB][PB + 1];    // and of the tile's rows
    __shared__ volatile int dcol;       // the factor's columns in Dt
    __shared__ int s_fail;
    const int x = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int j0 = k * PB, w = min(PB, n - j0), jp = j0 - PB;
    const bool panel = blockIdx.x < npanel;
    // this CTA's tile: rows r0 .., columns c0 ..; a panel CTA also takes the diagonal block
    int r0, c0, cw;
    if (panel) {
        c0 = j0;
        cw = w;
        r0 = j0 + w + PB * blockIdx.x;
    } else {
        const int R0 = (n + 1 + PB - 1) / PB;   // row blocks of the augmented matrix
        int t = blockIdx.x - npanel, J = k + 1;
        while (t >= R0 - J) {
            t -= R0 - J;
            ++J;
        }
        c0 = J * PB;
        cw = min(PB, n - c0);
        r0 = c0 + PB * t;
    }
    const int rb = min(PB, n + 1 - r0);
    {   // every load in flight before the first store to shared memory
        float t[PB / WARPS], lt[PB / WARPS], ld[PB / WARPS], dd[PB / WARPS];
#pragma unroll
        for (int q = 0; q < PB / WARPS; ++q) {
            const int y = wid + WARPS * q, i = r0 + y, j = c0 + x, id = j0 + y;
            t[q] = y < rb && x < cw && i >= j ? (k == 0 ? source(S, r, n, i, j) : A[(size_t)i * n + j])
                                              : 0.0f;
            lt[q] = k > 0 && y < rb ? A[(size_t)i * n + jp + x] : 0.0f;
            ld[q] = k > 0 && y < cw ? A[(size_t)(c0 + y) * n + jp + x] : 0.0f;
            // lower entries, the identity past w (its factor is itself)
            dd[q] = panel && y < w && x < w && x <= y
                        ? (k == 0 ? source(S, r, n, id, j) : A[(size_t)id * n + j])
                        : (x == y && (y >= w || x >= w) ? 1.0f : 0.0f);
        }
#pragma unroll
        for (int q = 0; q < PB / WARPS; ++q) {
            const int y = wid + WARPS * q;
            T[y][x] = t[q];
            LT[y][x] = lt[q];
            LD[y][x] = ld[q];
            D[y][x] = dd[q];
        }
    }
    if (threadIdx.x == 0) {
        s_fail = 0;
        dcol = 0;
    }
    __syncthreads();
    if (!panel) {
        if (k > 0) {
            tile_terms(T, LT, LD, x, wid, WARPS);
            __syncthreads();
        }
#pragma unroll
        for (int q = 0; q < PB / WARPS; ++q) {
            const int y = wid + WARPS * q, i = r0 + y, j = c0 + x;
            if (y < rb && x < cw && i >= j) A[(size_t)i * n + j] = T[y][x];
        }
        return;
    }
    if (k > 0) {
        tile_terms(D, LD, LD, x, wid, WARPS);
        __syncthreads();
    }
    if (wid == 0) {
        // the diagonal block: lane i holds row i; column jj's pivot is shuffled to every
        // lane, each takes its square root, the rows below divide and publish column jj
        // (Dt, dcol), then each entry (i, c), jj < c <= i, takes its term L_i,jj L_c,jj
        float a[PB];
#pragma unroll
        for (int c = 0; c < PB; ++c) a[c] = D[x][c];
        bool bad = false;
        float piv = __shfl_sync(FULL, a[0], 0);
#pragma unroll
        for (int jj = 0; jj < PB; ++jj) {
            const float ljj = sqrtf(piv);
            bad |= jj < w && !(piv > 0.0f);
            // every lane divides; lanes above the diagonal take l = 0, so their scratch
            // entries stay 0 and their divisions take div_rn's product
            const float q = div_rn(a[jj], ljj);
            const float l = x == jj ? ljj : (x > jj ? q : 0.0f);
            a[jj] = l;
            // the next pivot first: lane jj + 1's own term L_jj+1,jj^2 (the same product
            // its update below subtracts, so the same bits)
            if (jj + 1 < PB) piv = __shfl_sync(FULL, a[jj + 1] - l * l, jj + 1);
            Dt[jj][x] = l;
            __syncwarp();
            if ((jj & 3) == 3) {      // the row solve may take four more columns
                __threadfence_block();
                dcol = jj + 1;
            }
            // entry (x, c) takes L_x,jj L_c,jj for every c > jj; entries above the
            // diagonal (c > x) are scratch (0 but on lane jj's row), never read
#pragma unroll
            for (int q = (jj + 1) / 4; q < PB / 4; ++q) {
                const float4 l4 = reinterpret_cast<const float4*>(Dt[jj])[q];
                const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (4 * q + e > jj) a[4 * q + e] -= l * lv[e];
            }
        }
#pragma unroll
        for (int c = 0; c < PB; ++c) D[x][c] = a[c];
        if (x == 0 && bad) s_fail = 1;
    } else if ((wid & 3) != 0) {
        // the tile's terms on the warps off warp 0's scheduler (warps 4k share it)
        if (k > 0) {
            tile_terms(T, LT, LD, x, wid - 1 - (wid >> 2), WARPS - WARPS / 4);
            asm volatile("bar.sync 1, %0;" ::"r"(THREADS - THREADS / 4));
        }
        if (wid == 1) {
            // the tile's rows, a thread a row, up to four columns behind the diagonal
            // block: column jj's division, then its terms on the later columns
            float a[PB];
#pragma unroll
            for (int c = 0; c < PB; ++c) a[c] = T[x][c];
#pragma unroll
            for (int jj = 0; jj < PB; ++jj) {
                if ((jj & 3) == 0) {  // the diagonal block publishes four columns at a time
                    if (dcol < jj + 4) {
                        const unsigned long long t0 = now_ns();
                        while (dcol < jj + 4)
                            if (now_ns() - t0 > SPIN_LIMIT_NS) __trap();
                    }
                    __threadfence_block();
                }
                const float l = div_rn(a[jj], Dt[jj][jj]);
                a[jj] = l;
#pragma unroll
                for (int q = (jj + 1) / 4; q < PB / 4; ++q) {
                    const float4 l4 = reinterpret_cast<const float4*>(Dt[jj])[q];
                    const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (4 * q + e > jj) a[4 * q + e] -= l * lv[e];
                }
            }
#pragma unroll
            for (int c = 0; c < PB; ++c) T[x][c] = a[c];
        }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PB / WARPS; ++q) {
        const int y = wid + WARPS * q;
        if (y < rb && x < w) A[(size_t)(r0 + y) * n + j0 + x] = T[y][x];
        if (blockIdx.x == 0 && y < w && x <= y) A[(size_t)(j0 + y) * n + j0 + x] = D[y][x];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0 && s_fail) *fail = 1;
}

// L^T x = y by 32-row blocks from the last: warp 0 carries the chain (block b + 1's
// terms on block b, then block b's own), the helper threads (the warps off warp 0's
// scheduler) apply each solved block's terms to every row two and more blocks below
// it, four rows a thread at a time with their coefficients loaded before the block is
// solved; the shared counters `solved` and `hdone` (helper warps done with a block's
// terms) order them, no CTA barrier
__global__ void __launch_bounds__(BACK_THREADS) chol_back(const float* A, int n,
                                                          const int* fail, float* x) {
    extern __shared__ __align__(16) float v[];    // [n rounded up to 32]: y, then x; 0 past n
    __shared__ volatile int solved;               // blocks solved, from the last
    __shared__ int hdone[MAX_N / PB];             // helper warps done with block K's terms
    __shared__ float tile[RING][2][PB][PB + 1];   // block b's own tile and its next block's
    __shared__ volatile int ready[RING];          // the block each slot holds
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    // helpers: the warps off warp 0's scheduler (warps 4k share it and stay idle)
    const int NHW = BACK_THREADS / 32 - BACK_THREADS / 128, NHT = 32 * NHW, nb = (n + PB - 1) / PB;
    const float* y = A + (size_t)n * n;  // row n of the factor
    for (int i = tid; i < nb * PB; i += BACK_THREADS) v[i] = i < n ? y[i] : 0.0f;
    for (int b = tid; b < nb; b += BACK_THREADS) hdone[b] = 0;
    if (tid == 0) solved = 0;
    if (tid < RING) ready[tid] = -1;
    __syncthreads();
    if (wid == 0) {
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
                cf[jj] = tile[slot][0][jj][lane];
                tm[jj] = tile[slot][1][jj][lane];
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
                t0r[r] = A[(size_t)min(b0 + r, n) * n + min(b0 + lane, n - 1)];
                t1r[r] = A[(size_t)min(b0 + PB + r, n) * n + min(b0 + lane, n - 1)];
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
                    if (i < lim)              // terms past wK: clamped, unused
#pragma unroll
                        for (int mm = 0; mm < PB; ++mm) c[r][mm] = A[(size_t)min(K0 + mm, n) * n + i];
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
    const bool failed = *fail != 0;
    for (int i = tid; i < n; i += BACK_THREADS) x[i] = failed ? __int_as_float(0x7fc00000) : v[i];
}

// x = S^-1 r for the symmetric S [n][n] (its lower triangle read); `A` holds
// (n + 1) * n floats of workspace, `fail` one int (set to 0 here).  Returns a
// cudaError_t (the first failing call's stops the rest).
extern "C" int chol_solve_launch(const float* S, const float* r, int n, float* A, int* fail,
                                 float* x, cudaStream_t stream) {
    if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
    static bool attrs_set = false;     // once a process, outside any stream capture
    cudaError_t e;
    if (!attrs_set) {
        e = cudaFuncSetAttribute(chol_back, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)(MAX_N * sizeof(float)));
        if (e != cudaSuccess) return (int)e;
        attrs_set = true;
    }
    const int nb = (n + PB - 1) / PB, R0 = (n + 1 + PB - 1) / PB;
    e = cudaMemsetAsync(fail, 0, sizeof(int), stream);
    if (e != cudaSuccess) return (int)e;
    for (int k = 0; k < nb; ++k) {
        const int j0 = k * PB, w = min(PB, n - j0);
        const int npanel = (n + 1 - j0 - w + PB - 1) / PB;
        int nwork = 0;
        for (int J = k + 1; J < nb; ++J) nwork += R0 - J;
        chol_panel<<<npanel + nwork, THREADS, 0, stream>>>(S, r, A, n, k, npanel, fail);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    chol_back<<<1, BACK_THREADS, (size_t)nb * PB * sizeof(float), stream>>>(A, n, fail, x);
    return (int)cudaGetLastError();
}
