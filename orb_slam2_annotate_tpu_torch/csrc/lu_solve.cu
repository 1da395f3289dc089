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
//
// The launches of one solve (lu_solve_launch), on the stream, no host read:
//   lu_panel (one CTA), for each panel p of PB columns: the panel's rows
//       j0 = PB p .. n - 1 staged in shared memory, its columns factored one
//       at a time (a block argmax, the swap inside the panel, the
//       multipliers, the panel's update); the pivots recorded.
//   lu_update (ceil(n / PB) - 1 CTAs of PB x PB threads), for each panel: CTA
//       q takes the PB columns of tile q outside the panel: the panel's swaps
//       (composed into one gather of the touched rows), then, right of the
//       panel, U's PB rows (each entry's chain over the panel's columns) and
//       every lower row's entries (the same chain), PB rows at a time.
//   lu_tri (one CTA): the swaps on b, then both triangles by PB-row blocks.
// Bound: the dependency chain, 2 ceil(n / PB) + 1 dependent launches; n^3 / 3
// multiply-subtracts (151 M at n = 768) are a few us of the card's float rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PB 32
#define THREADS 1024
#define FULL 0xffffffffu
#define MAX_N 1728   // the panel's rows of PB + 1 floats in a CTA's shared memory

// a beats b as the pivot: a NaN above every number, then the larger value,
// then (equal) the lower row
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
    if (isnan(va)) return isnan(vb) ? ia < ib : true;
    if (isnan(vb)) return false;
    return va == vb ? ia < ib : va > vb;
}

__global__ void __launch_bounds__(THREADS) lu_panel(float* A, int n, int p, int* piv) {
    extern __shared__ float P[];       // [m][PB + 1]: rows j0.., the panel's columns
    __shared__ float wv[THREADS / 32];
    __shared__ int wi[THREADS / 32];
    __shared__ int s_pr;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int j0 = p * PB, w = min(PB, n - j0), m = n - j0, ld = PB + 1;
    for (int idx = tid; idx < m * PB; idx += THREADS) {
        const int r = idx / PB, c = idx % PB;
        P[r * ld + c] = c < w ? A[(size_t)(j0 + r) * n + j0 + c] : 0.0f;
    }
    __syncthreads();
    for (int jj = 0; jj < w; ++jj) {
        float bv = 0.0f;
        int bi = -1;
        for (int r = jj + tid; r < m; r += THREADS) {
            const float v = fabsf(P[r * ld + jj]);
            if (bi < 0 || beats(v, r, bv, bi)) { bv = v; bi = r; }
        }
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(FULL, bv, off);
            const int oi = __shfl_down_sync(FULL, bi, off);
            if (oi >= 0 && (bi < 0 || beats(ov, oi, bv, bi))) { bv = ov; bi = oi; }
        }
        if (lane == 0) { wv[warp] = bv; wi[warp] = bi; }
        __syncthreads();
        if (warp == 0) {
            bv = wv[lane];
            bi = wi[lane];
            for (int off = 16; off > 0; off >>= 1) {
                const float ov = __shfl_down_sync(FULL, bv, off);
                const int oi = __shfl_down_sync(FULL, bi, off);
                if (oi >= 0 && (bi < 0 || beats(ov, oi, bv, bi))) { bv = ov; bi = oi; }
            }
            if (lane == 0) {
                s_pr = bi;
                piv[j0 + jj] = j0 + bi;
            }
        }
        __syncthreads();
        const int pr = s_pr;
        if (pr != jj && tid < PB) {
            const float a = P[jj * ld + tid];
            P[jj * ld + tid] = P[pr * ld + tid];
            P[pr * ld + tid] = a;
        }
        __syncthreads();
        const float pivot = P[jj * ld + jj];
        for (int r = jj + 1 + tid; r < m; r += THREADS) P[r * ld + jj] = P[r * ld + jj] / pivot;
        __syncthreads();
        const int cols = w - jj - 1;
        if (cols > 0)
            for (int idx = tid; idx < (m - jj - 1) * cols; idx += THREADS) {
                const int r = jj + 1 + idx / cols, c = jj + 1 + idx % cols;
                P[r * ld + c] -= P[r * ld + jj] * P[jj * ld + c];
            }
        __syncthreads();
    }
    for (int idx = tid; idx < m * w; idx += THREADS) {
        const int r = idx / w, c = idx % w;
        A[(size_t)(j0 + r) * n + j0 + c] = P[r * ld + c];
    }
}

__global__ void __launch_bounds__(PB * PB) lu_update(float* A, int n, int p, const int* piv) {
    __shared__ int rows[2 * PB], src[2 * PB], s_nt;
    __shared__ float G[2 * PB][PB + 1];   // the touched rows' entries of this tile
    __shared__ float U[PB][PB + 1];       // U's panel rows, this tile's columns
    __shared__ float sL[PB][PB + 1];      // L's panel columns, PB rows at a time
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int j0 = p * PB, w = min(PB, n - j0);
    const int tile = blockIdx.x < p ? blockIdx.x : blockIdx.x + 1;   // the panel's tile skipped
    const int c = tile * PB + tx;
    if (tx == 0 && ty == 0) {            // the panel's swaps as one gather of the touched rows
        int nt = 0;
        auto slot = [&](int r) {
            for (int t = 0; t < nt; ++t)
                if (rows[t] == r) return t;
            rows[nt] = r;
            src[nt] = r;
            return nt++;
        };
        for (int jj = 0; jj < w; ++jj) {
            const int a = slot(j0 + jj), b = slot(piv[j0 + jj]);
            const int s = src[a];
            src[a] = src[b];
            src[b] = s;
        }
        s_nt = nt;
    }
    __syncthreads();
    const int nt = s_nt;
    for (int t = ty; t < nt; t += PB) G[t][tx] = c < n ? A[(size_t)src[t] * n + c] : 0.0f;
    __syncthreads();
    for (int t = ty; t < nt; t += PB)
        if (c < n) A[(size_t)rows[t] * n + c] = G[t][tx];
    if (tile * PB < j0) return;          // left of the panel: L's columns, swapped only
    __syncthreads();
    // U's panel rows in this tile's columns: entry (j0 + k, c)'s chain over the panel's columns
    for (int t = ty; t < w; t += PB) sL[t][tx] = tx < w ? A[(size_t)(j0 + t) * n + j0 + tx] : 0.0f;
    __syncthreads();
    if (ty == 0 && c < n) {
        for (int k = 0; k < w; ++k) {
            float u = A[(size_t)(j0 + k) * n + c];
            for (int mm = 0; mm < k; ++mm) u -= sL[k][mm] * U[mm][tx];
            U[k][tx] = u;
            A[(size_t)(j0 + k) * n + c] = u;
        }
    }
    __syncthreads();
    // the rows below the panel, PB at a time: entry (i, c) -= L_i,j0+mm U_j0+mm,c in ascending mm
    for (int i0 = j0 + w; i0 < n; i0 += PB) {
        const int i = i0 + ty;
        sL[ty][tx] = i < n && tx < w ? A[(size_t)i * n + j0 + tx] : 0.0f;
        __syncthreads();
        if (i < n && c < n) {
            float a = A[(size_t)i * n + c];
            for (int mm = 0; mm < w; ++mm) a -= sL[ty][mm] * U[mm][tx];
            A[(size_t)i * n + c] = a;
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(THREADS) lu_tri(const float* __restrict__ A,
                                                  const float* __restrict__ b,
                                                  const int* __restrict__ piv, int n, float* x) {
    extern __shared__ float y[];        // [n]
    __shared__ float Db[PB][PB + 1];    // the block's diagonal square of A
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nb = (n + PB - 1) / PB;
    for (int i = tid; i < n; i += THREADS) y[i] = b[i];
    __syncthreads();
    if (tid == 0)
        for (int k = 0; k < n; ++k) {
            const int q = piv[k];
            const float s = y[k];
            y[k] = y[q];
            y[q] = s;
        }
    // L y = P b, L unit lower: block kb's own chains, then its terms in every later row
    for (int kb = 0; kb < nb; ++kb) {
        const int k0 = kb * PB, wb = min(PB, n - k0);
        {
            const int a = tid / PB, bb = tid % PB;
            if (a < wb && bb < wb) Db[a][bb] = A[(size_t)(k0 + a) * n + k0 + bb];
        }
        __syncthreads();
        if (warp == 0) {
            float vi = lane < wb ? y[k0 + lane] : 0.0f;
            for (int jj = 0; jj < wb; ++jj) {
                const float yj = __shfl_sync(FULL, vi, jj);
                if (lane > jj && lane < wb) vi -= Db[lane][jj] * yj;
            }
            if (lane < wb) y[k0 + lane] = vi;
        }
        __syncthreads();
        for (int row = k0 + PB + tid; row < n; row += THREADS) {
            const float* Ar = A + (size_t)row * n + k0;
            float s = y[row];
#pragma unroll 8
            for (int mm = 0; mm < PB; ++mm) s -= Ar[mm] * y[k0 + mm];
            y[row] = s;
        }
        __syncthreads();
    }
    // U x = y: blocks from the last, each chain's terms in descending k
    for (int kb = nb - 1; kb >= 0; --kb) {
        const int k0 = kb * PB, wb = min(PB, n - k0);
        {
            const int a = tid / PB, bb = tid % PB;
            if (a < wb && bb < wb) Db[a][bb] = A[(size_t)(k0 + a) * n + k0 + bb];
        }
        __syncthreads();
        if (warp == 0) {
            float vi = lane < wb ? y[k0 + lane] : 0.0f;
            for (int jj = wb - 1; jj >= 0; --jj) {
                const float xj = __shfl_sync(FULL, vi, jj) / Db[jj][jj];
                if (lane == jj) vi = xj;
                if (lane < jj) vi -= Db[lane][jj] * xj;
            }
            if (lane < wb) y[k0 + lane] = vi;
        }
        __syncthreads();
        for (int row = tid; row < k0; row += THREADS) {
            const float* Ar = A + (size_t)row * n + k0;
            float s = y[row];
            for (int mm = wb - 1; mm >= 0; --mm) s -= Ar[mm] * y[k0 + mm];
            y[row] = s;
        }
        __syncthreads();
    }
    for (int i = tid; i < n; i += THREADS) x[i] = y[i];
}

static size_t panel_smem(int n) { return (size_t)n * (PB + 1) * sizeof(float); }

// x = S^-1 r for S [n][n]; `A` holds n * n floats of workspace (the factors),
// `piv` n ints.  Returns a cudaError_t (the first launch's error stops the
// rest).
extern "C" int lu_solve_launch(const float* S, const float* r, int n, float* A, int* piv,
                               float* x, cudaStream_t stream) {
    if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
    static bool attrs_set = false;     // once a process, outside any stream capture
    cudaError_t e;
    if (!attrs_set) {
        e = cudaFuncSetAttribute(lu_panel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)panel_smem(MAX_N));
        if (e != cudaSuccess) return (int)e;
        attrs_set = true;
    }
    e = cudaMemcpyAsync(A, S, (size_t)n * n * sizeof(float), cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return (int)e;
    const int nb = (n + PB - 1) / PB;
    for (int p = 0; p < nb; ++p) {
        lu_panel<<<1, THREADS, panel_smem(n - p * PB), stream>>>(A, n, p, piv);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        if (nb > 1) {
            lu_update<<<nb - 1, dim3(PB, PB), 0, stream>>>(A, n, p, piv);
            if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        }
    }
    lu_tri<<<1, THREADS, (size_t)n * sizeof(float), stream>>>(A, r, piv, n, x);
    return (int)cudaGetLastError();
}
