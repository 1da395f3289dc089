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
//   y_i  = (r_i - L_i0 y_0 - ... - L_i,i-1 y_i-1) / L_ii,
//   x_i  = (y_i - L_n-1,i x_n-1 - ... - L_i+1,i x_i+1) / L_ii   (k descending),
// each product rounded before its subtraction (--fmad=false), IEEE square
// roots and divisions.  Any schedule that keeps every chain's order gives
// these bits; the twin's is a column at a time.  The step is all NaN where a
// pivot is not > 0 (the reference's solve refused), so it is never taken.
//
// The launches of one solve (chol_solve_launch), on the stream, no host read:
//   chol_panel, for each panel p of PB columns (ceil(n / PB) launches,
//       ceil(n / PB) - p CTAs of PB x PB threads): CTA q takes the panel's
//       rows [PB (p + q), + PB) and, again, its diagonal block, a thread an
//       entry of each: its chain over the columns left of the panel (PB
//       columns at a time staged in shared memory), then the panel's own
//       columns one at a time (every CTA factors the diagonal block, to the
//       same bits; CTA 0 writes it and marks a pivot not > 0).
//   chol_tri (one CTA of TRI_THREADS): both triangles by PB-row blocks: the
//       block's diagonal staged in shared memory, a warp its own chains, then
//       a thread a row the block's terms.
// Bound: the dependency chain.  n^3 / 6 multiply-subtracts (75 M at n = 768,
// about 2 us of the card's float rate) in ceil(n / PB) dependent launches,
// and 2 n / PB dependent blocks of the two triangles.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PB 32
#define TRI_THREADS 1024
#define FULL 0xffffffffu
#define MAX_N 12288          // y of chol_tri in 48 KB of shared memory

__global__ void __launch_bounds__(PB * PB) chol_panel(const float* __restrict__ S, float* L, int n,
                                                      int p, int* fail) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int j0 = p * PB, i0 = j0 + blockIdx.x * PB;
    const int i = i0 + ty, jd = j0 + ty, j = j0 + tx;   // tile entry (i, j), diagonal one (jd, j)
    __shared__ float sR[PB][PB + 1];   // L rows i0.., a stage of PB columns
    __shared__ float sD[PB][PB + 1];   // L rows j0.., the same columns
    __shared__ float T[PB][PB + 1];    // the tile
    __shared__ float D[PB][PB + 1];    // the diagonal block
    if (p == 0 && blockIdx.x == 0 && tx == 0 && ty == 0) *fail = 0;
    float acc = i < n && j < n ? S[(size_t)i * n + j] : 0.0f;
    float accd = jd < n && j < n ? S[(size_t)jd * n + j] : 0.0f;
    for (int kc = 0; kc < j0; kc += PB) {
        sR[ty][tx] = i < n ? L[(size_t)i * n + kc + tx] : 0.0f;
        sD[ty][tx] = jd < n ? L[(size_t)jd * n + kc + tx] : 0.0f;
        __syncthreads();
#pragma unroll 8
        for (int m = 0; m < PB; ++m) {
            acc -= sR[ty][m] * sD[tx][m];
            accd -= sD[ty][m] * sD[tx][m];
        }
        __syncthreads();
    }
    T[ty][tx] = acc;
    D[ty][tx] = accd;
    // the panel's own columns: D[jj][jj] keeps the pivot (its square root is L_jj)
    for (int jj = 0; jj < PB && j0 + jj < n; ++jj) {
        __syncthreads();
        const float ljj = sqrtf(D[jj][jj]);
        if (tx == jj) {
            if (ty > jj) D[ty][jj] = D[ty][jj] / ljj;
            T[ty][jj] = T[ty][jj] / ljj;
        }
        __syncthreads();
        if (tx > jj) {
            if (tx <= ty) D[ty][tx] -= D[ty][jj] * D[tx][jj];
            T[ty][tx] -= T[ty][jj] * D[tx][jj];
        }
    }
    __syncthreads();
    if (blockIdx.x == 0) {
        if (jd < n && j < n && tx <= ty) {
            const float piv = D[ty][ty];
            L[(size_t)jd * n + j] = tx == ty ? sqrtf(piv) : D[ty][tx];
            if (tx == ty && !(piv > 0.0f)) *fail = 1;   // the same value from any thread
        }
    } else if (i < n && j < n) {
        L[(size_t)i * n + j] = T[ty][tx];
    }
}

__global__ void __launch_bounds__(TRI_THREADS) chol_tri(const float* __restrict__ L,
                                                        const float* __restrict__ r, int n,
                                                        const int* fail, float* x) {
    extern __shared__ float y[];        // [n]
    __shared__ float Db[PB][PB + 1];    // the block's diagonal square of L
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nb = (n + PB - 1) / PB;
    for (int i = tid; i < n; i += TRI_THREADS) y[i] = r[i];
    // L y = r: block kb's own chains, then its terms in every later row
    for (int kb = 0; kb < nb; ++kb) {
        const int k0 = kb * PB, w = min(PB, n - k0);
        {
            const int a = tid / PB, b = tid % PB;
            if (a < w && b <= a) Db[a][b] = L[(size_t)(k0 + a) * n + k0 + b];
        }
        __syncthreads();
        if (warp == 0) {
            float vi = lane < w ? y[k0 + lane] : 0.0f;
            for (int jj = 0; jj < w; ++jj) {
                const float yj = __shfl_sync(FULL, vi, jj) / Db[jj][jj];
                if (lane == jj) vi = yj;
                if (lane > jj && lane < w) vi -= Db[lane][jj] * yj;
            }
            if (lane < w) y[k0 + lane] = vi;
        }
        __syncthreads();
        for (int row = k0 + PB + tid; row < n; row += TRI_THREADS) {
            const float* Lr = L + (size_t)row * n + k0;
            float s = y[row];
#pragma unroll 8
            for (int m = 0; m < PB; ++m) s -= Lr[m] * y[k0 + m];
            y[row] = s;
        }
        __syncthreads();
    }
    // L^T x = y: blocks from the last, each chain's terms in descending k
    for (int kb = nb - 1; kb >= 0; --kb) {
        const int k0 = kb * PB, w = min(PB, n - k0);
        {
            const int a = tid / PB, b = tid % PB;
            if (a < w && b <= a) Db[a][b] = L[(size_t)(k0 + a) * n + k0 + b];
        }
        __syncthreads();
        if (warp == 0) {
            float vi = lane < w ? y[k0 + lane] : 0.0f;
            for (int jj = w - 1; jj >= 0; --jj) {
                const float xj = __shfl_sync(FULL, vi, jj) / Db[jj][jj];
                if (lane == jj) vi = xj;
                if (lane < jj) vi -= Db[jj][lane] * xj;
            }
            if (lane < w) y[k0 + lane] = vi;
        }
        __syncthreads();
        for (int row = tid; row < k0; row += TRI_THREADS) {
            float s = y[row];
            for (int m = w - 1; m >= 0; --m) s -= L[(size_t)(k0 + m) * n + row] * y[k0 + m];
            y[row] = s;
        }
        __syncthreads();
    }
    const bool failed = *fail != 0;
    for (int i = tid; i < n; i += TRI_THREADS) x[i] = failed ? __int_as_float(0x7fc00000) : y[i];
}

// x = S^-1 r for the symmetric S [n][n] (its lower triangle read); `L`
// holds n * n floats of workspace, `fail` one int.  Returns a cudaError_t
// (the first launch's error stops the rest).
extern "C" int chol_solve_launch(const float* S, const float* r, int n, float* L, int* fail,
                                 float* x, cudaStream_t stream) {
    if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
    const int nb = (n + PB - 1) / PB;
    cudaError_t e;
    for (int p = 0; p < nb; ++p) {
        chol_panel<<<nb - p, dim3(PB, PB), 0, stream>>>(S, L, n, p, fail);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    chol_tri<<<1, TRI_THREADS, (size_t)n * sizeof(float), stream>>>(L, r, n, fail, x);
    return (int)cudaGetLastError();
}
