// Kernel 6: relocalization's PnP hypotheses in one launch: every sampled
// minimal set's DLT pose, its inlier count, and each candidate's best.
//
// Replaces (JAX reference): solvers/pnp.py pnp_ransac's vmapped _dlt_pnp
// (:40, :87), the vmapped `score` (:90-100) and the argmax (:101), run across
// the 8 candidates of pipeline/tracking.py relocalize_candidates.  On the
// main path C = 8 candidates x S = 256 hypotheses x N = 1024 points.
//
// Bound: operations.  A hypothesis's Jacobi sweeps cost ~120k flops (8
// sweeps x 66 column pairs x 227: three 12-term dot products, the rotation,
// 24 entries of each column updated), its polar factor and cube root ~1.4k;
// scoring is ~33 operations a point and hypothesis.  At the f32 rate that is
// ~4 us for C x S = 2048; the bytes (the points, staged once per CTA, and
// the 52 bytes out per hypothesis) take far less.
//
// Design: one CTA of 8 warps takes 16 hypotheses of one candidate and
// stages that candidate's points (xw, uv, valid) in shared memory.  Each
// half-warp solves one hypothesis: lane j < 12 holds column j of the 12x12
// DLT system (the reference's 13th row is zero) and column j of the
// accumulated rotation V.  One-sided (Hestenes) Jacobi runs NULL_SWEEPS
// sweeps of the round-robin order, 11 rounds of 6 disjoint column pairs:
// in round r lane j pairs with (2r - j) mod 11, lane 11 with lane r.  Both
// lanes of a pair fetch the other's columns by shuffle and compute the same
// rotation from the same numbers.  A pair rotates only while |gamma| >
// 2^-24 sqrt(alpha beta).  The null vector is V's column with the
// shortest image (the first on ties); every lane of the half then takes the
// same scale (a cube root from square roots and Newton steps), the polar
// factor (Jacobi on M's three columns, the shortest column of U the cross
// product of the other two) and the sign fix, redundantly in registers.
// The half-warp then counts its hypothesis's inliers over the staged points
// and writes R, t and the count.  The last CTA of each candidate to finish
// (an atomic ticket taken after __threadfence()) picks the first hypothesis
// with the most inliers, by a maximum of (count << 16 | S - 1 - s), writes
// it, and resets the ticket for the next call.
//
// Bit for bit as the plain torch twin (kernels/pnp_score.py
// pnp_hypotheses_plain): every operation is +, -, x, / or sqrt, each
// correctly rounded, in the twin's order, built with --fmad=false; sums run
// term by term in a fixed tree; the minima take the first index on ties.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define HPB (NT / 16)        // hypotheses per CTA: one per half-warp
#define NULL_SWEEPS 8        // kernels/pnp_score.py NULL_SWEEPS
#define POLAR_SWEEPS 6       // POLAR_SWEEPS
#define NEWTON_STEPS 4       // NEWTON_STEPS
#define CBRT_TINY 1e-36f     // CBRT_TINY
#define ORTHO_TOL2 0x1p-48f  // ORTHO_TOL2
#define FULL 0xffffffffu

// (c, s) of the rotation that orthogonalises two columns with squared
// norms alpha, beta and inner product gamma; (1, 0) once they are
// orthogonal to float32 precision.  A branch, not a select: a converged
// pair would send the divisions below into their slow path (zeta overflows).
__device__ __forceinline__ void jacobi_rotation(float alpha, float beta, float gamma, float& c,
                                                float& s) {
    c = 1.f;
    s = 0.f;
    if (gamma * gamma > (ORTHO_TOL2 * alpha) * beta) {
        const float zeta = (beta - alpha) / (gamma + gamma);
        const float sgn = zeta >= 0.f ? 1.f : -1.f;
        const float t = sgn / (fabsf(zeta) + sqrtf(1.f + zeta * zeta));
        c = 1.f / sqrtf(1.f + t * t);
        s = c * t;
    }
}

// a sum of 12 terms as a fixed tree: pairs, pairs of pairs, then
// (first + second) + third (kernels/pnp_score.py _dot)
__device__ __forceinline__ float sum12(const float (&p)[12]) {
    const float q0 = p[0] + p[1], q1 = p[2] + p[3], q2 = p[4] + p[5];
    const float q3 = p[6] + p[7], q4 = p[8] + p[9], q5 = p[10] + p[11];
    return ((q0 + q1) + (q2 + q3)) + (q4 + q5);
}

__device__ __forceinline__ float det3(const float (&m)[3][3]) {
    return (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
            - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]))
           + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
}

__device__ __forceinline__ float dot3(const float (&a)[3], const float (&b)[3]) {
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

__device__ __forceinline__ float cbrt_newton(float a) {
    float r = sqrtf(sqrtf(a));
    float x = r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        r = sqrtf(sqrtf(r));
        x = x * r;
    }
#pragma unroll
    for (int i = 0; i < NEWTON_STEPS; ++i) x = ((x + x) + a / (x * x)) / 3.f;
    return x;
}

__global__ void __launch_bounds__(NT) pnp_hypotheses_kernel(
    const long long* __restrict__ samples, const float* __restrict__ xw,
    const float* __restrict__ uv, const uint8_t* __restrict__ valid, int S, int N, float fx,
    float fy, float cx, float cy, float th, float* __restrict__ Rs, float* __restrict__ ts,
    int* __restrict__ ns, long long* __restrict__ best, unsigned* __restrict__ ticket) {
    extern __shared__ __align__(16) float smem[];
    float* sx = smem;                                  // [N,3]
    float* suv = smem + 3 * N;                         // [N,2]
    uint8_t* sv = reinterpret_cast<uint8_t*>(smem + 5 * N);
    __shared__ int s_key, is_last;

    const int c = blockIdx.y, tid = threadIdx.x;
    for (int i = tid; i < 3 * N; i += NT) sx[i] = xw[(size_t)c * N * 3 + i];
    for (int i = tid; i < 2 * N; i += NT) suv[i] = uv[i];
    for (int i = tid; i < N; i += NT) sv[i] = valid[(size_t)c * N + i];
    __syncthreads();

    const int j = tid & 15;                            // column / lane within the half-warp
    const int h = blockIdx.x * HPB + (tid >> 4);       // hypothesis
    const int hs = min(h, S - 1);                      // past S: solve a copy, write nothing

    // column j of the DLT system: rows k < 6 are [X, 0, -u X] of point k,
    // rows 6 + k are [0, X, -v X]
    float a[12], v[12];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        const long long raw = samples[((size_t)c * S + hs) * 6 + k];
        const int i = (int)min(max(raw, 0ll), (long long)(N - 1));
        const float x = sx[3 * i], y = sx[3 * i + 1], z = sx[3 * i + 2];
        const float u = (suv[2 * i] - cx) / fx, w = (suv[2 * i + 1] - cy) / fy;
        const int e = j & 3;
        const float Xe = e == 0 ? x : (e == 1 ? y : (e == 2 ? z : 1.f));
        a[k] = j < 4 ? Xe : (j < 8 ? 0.f : (j < 12 ? (-u) * Xe : 0.f));
        a[6 + k] = j < 4 ? 0.f : (j < 8 ? Xe : (j < 12 ? (-w) * Xe : 0.f));
    }
#pragma unroll
    for (int r = 0; r < 12; ++r) v[r] = r == j ? 1.f : 0.f;

    for (int sweep = 0; sweep < NULL_SWEEPS; ++sweep) {
        for (int rd = 0; rd < 11; ++rd) {
            int p = j;
            if (j == 11) p = rd;
            else if (j == rd) p = 11;
            else if (j < 11) p = ((2 * rd - j) % 11 + 11) % 11;
            float sq[12];
#pragma unroll
            for (int r = 0; r < 12; ++r) sq[r] = a[r] * a[r];
            const float nrm = sum12(sq);
            const float pn = __shfl_sync(FULL, nrm, p, 16);
            float pa[12], pv[12];
#pragma unroll
            for (int r = 0; r < 12; ++r) {
                pa[r] = __shfl_sync(FULL, a[r], p, 16);
                pv[r] = __shfl_sync(FULL, v[r], p, 16);
            }
            if (p != j) {
                const bool lo = j < p;
                float pr[12];
#pragma unroll
                for (int r = 0; r < 12; ++r) pr[r] = a[r] * pa[r];
                const float gamma = sum12(pr);
                float cs, sn;
                jacobi_rotation(lo ? nrm : pn, lo ? pn : nrm, gamma, cs, sn);
                // low column: c x - s y = c x + (-s) y; high column: s x + c y
                // = c y + s x (x low, y high): exactly the twin's roundings
                const float so = lo ? -sn : sn;
#pragma unroll
                for (int r = 0; r < 12; ++r) {
                    a[r] = cs * a[r] + so * pa[r];
                    v[r] = cs * v[r] + so * pv[r];
                }
            }
        }
    }

    // the null vector: V's column whose image is shortest, the first on ties
    float sq[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) sq[r] = a[r] * a[r];
    const float nrm = sum12(sq);
    float bn = __shfl_sync(FULL, nrm, 0, 16);
    int kmin = 0;
    for (int i = 1; i < 12; ++i) {
        const float ni = __shfl_sync(FULL, nrm, i, 16);
        if (ni < bn) { bn = ni; kmin = i; }
    }
    float P[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) P[r] = __shfl_sync(FULL, v[r], kmin, 16);

    // scale: |det M|^(1/3) with the sign of det M, floored at 1e-12
    float M[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q) M[r][q] = P[4 * r + q];
    const float det = det3(M);
    const float ad = fabsf(det);
    const bool tiny = ad < CBRT_TINY;
    const float xr = cbrt_newton(tiny ? 1.f : ad);
    float s = tiny ? 1e-12f : (det > 0.f ? xr : -xr);
    s = fabsf(s) < 1e-12f ? 1e-12f : s;

    // polar factor of M / s: Jacobi on its columns b, rotations into W
    float b[3][3], W[3][3];                            // [column][row]
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            b[q][r] = M[r][q] / s;
            W[q][r] = q == r ? 1.f : 0.f;
        }
    for (int sweep = 0; sweep < POLAR_SWEEPS; ++sweep) {
#pragma unroll
        for (int pr = 0; pr < 3; ++pr) {
            const int p = pr == 2 ? 1 : 0, q = pr == 0 ? 1 : 2;
            float cs, sn;
            jacobi_rotation(dot3(b[p], b[p]), dot3(b[q], b[q]), dot3(b[p], b[q]), cs, sn);
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const float bp = b[p][r], bq = b[q][r], wp = W[p][r], wq = W[q][r];
                b[p][r] = cs * bp - sn * bq;
                b[q][r] = sn * bp + cs * bq;
                W[p][r] = cs * wp - sn * wq;
                W[q][r] = sn * wp + cs * wq;
            }
        }
    }
    float n2[3], U[3][3];                              // [column][row]
#pragma unroll
    for (int q = 0; q < 3; ++q) n2[q] = dot3(b[q], b[q]);
    const int ks = n2[1] < n2[0] ? (n2[2] < n2[1] ? 2 : 1) : (n2[2] < n2[0] ? 2 : 0);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        const float nq = sqrtf(n2[q]);
#pragma unroll
        for (int r = 0; r < 3; ++r) U[q][r] = b[q][r] / nq;
    }
    {
        const int q1 = (ks + 1) % 3, q2 = (ks + 2) % 3;
        float x0 = 0.f, x1 = 0.f, x2 = 0.f, y0 = 0.f, y1 = 0.f, y2 = 0.f;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            if (q == q1) { x0 = U[q][0]; x1 = U[q][1]; x2 = U[q][2]; }
            if (q == q2) { y0 = U[q][0]; y1 = U[q][1]; y2 = U[q][2]; }
        }
        const float c0 = x1 * y2 - x2 * y1, c1 = x2 * y0 - x0 * y2, c2 = x0 * y1 - x1 * y0;
#pragma unroll
        for (int q = 0; q < 3; ++q)
            if (q == ks) { U[q][0] = c0; U[q][1] = c1; U[q][2] = c2; }
    }
    float R[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q)
            R[r][q] = (U[0][r] * W[0][q] + U[1][r] * W[1][q]) + U[2][r] * W[2][q];
    const float dR = det3(R);
    const float sgn = (dR > 0.f ? 1.f : 0.f) - (dR < 0.f ? 1.f : 0.f);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int q = 0; q < 3; ++q) R[r][q] = R[r][q] * sgn;
    const float t0 = P[3] / s, t1 = P[7] / s, t2 = P[11] / s;

    // inliers over the staged points, 16 lanes per hypothesis
    int n_in = 0;
    for (int n = j; n < N; n += 16) {
        const float x = sx[3 * n], y = sx[3 * n + 1], z = sx[3 * n + 2];
        const float xc = ((x * R[0][0] + y * R[0][1]) + z * R[0][2]) + t0;
        const float yc = ((x * R[1][0] + y * R[1][1]) + z * R[1][2]) + t1;
        const float zc = ((x * R[2][0] + y * R[2][1]) + z * R[2][2]) + t2;
        const bool zok = zc > 1e-3f;
        const float zs = zok ? zc : 1.0f;
        const float du = (fx * xc / zs + cx) - suv[2 * n];
        const float dv = (fy * yc / zs + cy) - suv[2 * n + 1];
        n_in += (sv[n] && zok && (du * du + dv * dv < th)) ? 1 : 0;
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) n_in += __shfl_xor_sync(FULL, n_in, o, 16);
    if (h < S) {
        const size_t g = (size_t)c * S + h;
        if (j < 9) Rs[g * 9 + j] = R[j / 3][j % 3];
        if (j < 3) ts[g * 3 + j] = j == 0 ? t0 : (j == 1 ? t1 : t2);
        if (j == 0) ns[g] = n_in;
    }

    // the last CTA of candidate c picks its best hypothesis
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        is_last = atomicAdd(&ticket[c], 1u) == gridDim.x - 1;
        s_key = -1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    int key = -1;
    for (int i = tid; i < S; i += NT)
        key = max(key, (__ldcg(&ns[(size_t)c * S + i]) << 16) | (S - 1 - i));
    atomicMax(&s_key, key);
    __syncthreads();
    if (tid == 0) {
        best[c] = S - 1 - (s_key & 0xffff);
        ticket[c] = 0u;
    }
}

// ticket [>= C] holds 0 between calls.
extern "C" int pnp_hypotheses_launch(const long long* samples, const float* xw, const float* uv,
                                     const uint8_t* valid, int C, int S, int N, float fx, float fy,
                                     float cx, float cy, float th, float* Rs, float* ts, int* ns,
                                     long long* best, unsigned* ticket, cudaStream_t stream) {
    if (C == 0 || S == 0) return (int)cudaGetLastError();
    const size_t smem = (size_t)N * 5 * sizeof(float) + (((size_t)N + 15) / 16) * 16;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pnp_hypotheses_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((S + HPB - 1) / HPB, C);
    pnp_hypotheses_kernel<<<grid, NT, smem, stream>>>(samples, xw, uv, valid, S, N, fx, fy, cx, cy,
                                                      th, Rs, ts, ns, best, ticket);
    return (int)cudaGetLastError();
}
