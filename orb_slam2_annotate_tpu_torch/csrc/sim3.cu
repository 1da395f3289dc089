// Kernels 7 and 8: loop closing's Sim3 RANSAC hypotheses, and its Sim3 LM.
//
// Kernel 7, sim3_hypotheses: replaces (JAX reference) solvers/sim3.py
// sim3_ransac's vmapped horn_sim3 (:96-104), the vmapped `score` (:106-127)
// and the argmax (:129).  On the main path H = 1024 sampled triples of
// N = 1024 pairs (a keyframe's features).
//
// Bound: operations.  Scoring is ~33 operations a pair and direction and
// hypothesis, ~69 M operations at H = N = 1024, ~1 us at 67 T/s; Horn's
// 4x4 Jacobi is ~2k operations a hypothesis.  The bytes (the pairs, staged
// once a CTA, and 56 B out a hypothesis) take far less.
//
// Design: one CTA of 8 warps stages the N pairs (x1, x2, uv1, uv2, the two
// inverse sigma^2 and valid: 49 B a pair) in shared memory; each warp takes
// one hypothesis.  Every lane of the warp fits the triple's Sim3 redundantly
// in registers: centroids, M = sum a b^T, Horn's Q, JACOBI_SWEEPS cyclic
// Jacobi sweeps of Q (a pair rotates only while q_pq^2 > 2^-48 (q_pp^2 +
// q_qq^2)), the eigenvector of the largest eigenvalue (the first on ties),
// R from it, the scale and t.  The lanes then count the pairs that
// reproject within th both ways, and a shuffle sum gives the count.  The
// last CTA to finish (an atomic ticket taken after __threadfence()) picks
// the first hypothesis with the most inliers by a maximum of
// (count << 16 | H - 1 - h), writes it and resets the ticket.
//
// Bit for bit as the plain twin (kernels/sim3.py sim3_hypotheses_plain):
// every operation is +, -, x, / or sqrt, each correctly rounded, in the
// twin's order, built with --fmad=false.
//
// Kernel 8, sim3_lm: replaces (JAX reference) solvers/sim3.py optimize_sim3
// (:172-259) with _sim3_project_residuals (:143), the jacfwd linearization
// through geometry/lie.py sim3_retract, jnp.linalg.solve and the chi2 inlier
// refresh.  K4's design (csrc/pose_lm.cu): one CTA, the pairs staged once
// in shared memory, no host read in between.  One iteration: (a) one pass
// over the pairs accumulates the 28 upper entries of H, the 7 of g (the
// analytic left-tangent Jacobian of both edges: d(exp(xi) p)/dxi = [I,
// -hat(p), p] forward, -(1/s) R^T [I, -hat(x2), x2] inverse) and the robust
// cost; (b) lanes 0-2 each take one ladder value, solve the damped 7x7 by
// Gaussian elimination with partial pivoting, and retract (sim3_exp with
// the reference's Taylor branches); (c) one pass costs the three
// candidates; (d) thread 0 takes the first improving one and updates
// lambda; (e) one pass refreshes the inlier mask.  Scale is frozen when
// fix_scale.  Bound: the dependency chain (8 iterations of barriers and a
// serial 7x7 solve), as for K4; ~8 x 1024 x ~600 operations is well under a
// microsecond at 67 T/s.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define NWARP (NT / 32)
#define JACOBI_SWEEPS 6      // kernels/sim3.py JACOBI_SWEEPS
#define ORTHO_TOL2 0x1p-48f  // ORTHO_TOL2
#define MAX_N 4096
#define PAIR_BYTES 49        // 12 floats and the valid byte
#define FULL 0xffffffffu

struct Pairs {
    float *x1, *x2, *uv1, *uv2, *is1, *is2;
    uint8_t* v;
};

// Stage the pairs as planes: x1 [3N], x2 [3N], uv1 [2N], uv2 [2N], is1 [N],
// is2 [N], valid [N].
__device__ __forceinline__ Pairs stage(unsigned char* smem, int N, const float* x1,
                                       const float* x2, const float* uv1, const float* uv2,
                                       const uint8_t* valid, const float* is1,
                                       const float* is2) {
    Pairs p;
    float* f = reinterpret_cast<float*>(smem);
    p.x1 = f;
    p.x2 = f + 3 * N;
    p.uv1 = f + 6 * N;
    p.uv2 = f + 8 * N;
    p.is1 = f + 10 * N;
    p.is2 = f + 11 * N;
    p.v = reinterpret_cast<uint8_t*>(f + 12 * N);
    for (int i = threadIdx.x; i < 3 * N; i += blockDim.x) {
        p.x1[i] = x1[i];
        p.x2[i] = x2[i];
    }
    for (int i = threadIdx.x; i < 2 * N; i += blockDim.x) {
        p.uv1[i] = uv1[i];
        p.uv2[i] = uv2[i];
    }
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        p.is1[i] = is1[i];
        p.is2[i] = is2[i];
        p.v[i] = valid[i] ? 1 : 0;
    }
    return p;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// Horn's Sim3 of one triple (p2 ~ s R p1 + t), in horn3_plain's order.
__device__ void horn3(const float (&p1)[3][3], const float (&p2)[3][3], bool fix_scale, float& s,
                      float (&R)[3][3], float (&t)[3]) {
    float c1[3], c2[3], a[3][3], b[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        c1[i] = ((p1[0][i] + p1[1][i]) + p1[2][i]) / 3.f;
        c2[i] = ((p2[0][i] + p2[1][i]) + p2[2][i]) / 3.f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            a[k][i] = p1[k][i] - c1[i];
            b[k][i] = p2[k][i] - c2[i];
        }
    float M[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) M[i][j] = (a[0][i] * b[0][j] + a[1][i] * b[1][j]) + a[2][i] * b[2][j];
    const float Sxx = M[0][0], Sxy = M[0][1], Sxz = M[0][2];
    const float Syx = M[1][0], Syy = M[1][1], Syz = M[1][2];
    const float Szx = M[2][0], Szy = M[2][1], Szz = M[2][2];
    float A[4][4] = {{(Sxx + Syy) + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx},
                     {Syz - Szy, (Sxx - Syy) - Szz, Sxy + Syx, Szx + Sxz},
                     {Szx - Sxz, Sxy + Syx, (-Sxx + Syy) - Szz, Syz + Szy},
                     {Sxy - Syx, Szx + Sxz, Syz + Szy, (-Sxx - Syy) + Szz}};
    float V[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) V[i][j] = i == j ? 1.f : 0.f;
    for (int sweep = 0; sweep < JACOBI_SWEEPS; ++sweep) {
#pragma unroll
        for (int pr = 0; pr < 6; ++pr) {
            const int p = pr < 3 ? 0 : (pr < 5 ? 1 : 2);
            const int q = pr < 3 ? pr + 1 : (pr < 5 ? pr - 1 : 3);
            const float app = A[p][p], aqq = A[q][q], apq = A[p][q];
            if (apq * apq > ORTHO_TOL2 * (app * app + aqq * aqq)) {
                const float theta = (aqq - app) / (apq + apq);
                const float sgn = theta >= 0.f ? 1.f : -1.f;
                const float tt = sgn / (fabsf(theta) + sqrtf(theta * theta + 1.f));
                const float c = 1.f / sqrtf(tt * tt + 1.f);
                const float sn = tt * c;
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    if (r == p || r == q) continue;
                    const float arp = A[r][p], arq = A[r][q];
                    A[r][p] = A[p][r] = c * arp - sn * arq;
                    A[r][q] = A[q][r] = sn * arp + c * arq;
                }
                A[p][p] = app - tt * apq;
                A[q][q] = aqq + tt * apq;
                A[p][q] = A[q][p] = 0.f;
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float vrp = V[r][p], vrq = V[r][q];
                    V[r][p] = c * vrp - sn * vrq;
                    V[r][q] = sn * vrp + c * vrq;
                }
            }
        }
    }
    int k = 0;
    float best = A[0][0];
#pragma unroll
    for (int i = 1; i < 4; ++i)
        if (A[i][i] > best) {
            best = A[i][i];
            k = i;
        }
    float qw = V[0][0], qx = V[1][0], qy = V[2][0], qz = V[3][0];
#pragma unroll
    for (int i = 1; i < 4; ++i)
        if (k == i) {
            qw = V[0][i];
            qx = V[1][i];
            qy = V[2][i];
            qz = V[3][i];
        }
    R[0][0] = 1.f - 2.f * (qy * qy + qz * qz);
    R[0][1] = 2.f * (qx * qy - qw * qz);
    R[0][2] = 2.f * (qx * qz + qw * qy);
    R[1][0] = 2.f * (qx * qy + qw * qz);
    R[1][1] = 1.f - 2.f * (qx * qx + qz * qz);
    R[1][2] = 2.f * (qy * qz - qw * qx);
    R[2][0] = 2.f * (qx * qz - qw * qy);
    R[2][1] = 2.f * (qy * qz + qw * qx);
    R[2][2] = 1.f - 2.f * (qx * qx + qy * qy);
    float Ra[3][3];
#pragma unroll
    for (int kk = 0; kk < 3; ++kk)
#pragma unroll
        for (int i = 0; i < 3; ++i) Ra[kk][i] = dot3(R[i], a[kk]);
    const float num = (dot3(Ra[0], b[0]) + dot3(Ra[1], b[1])) + dot3(Ra[2], b[2]);
    const float den = fmaxf((dot3(Ra[0], Ra[0]) + dot3(Ra[1], Ra[1])) + dot3(Ra[2], Ra[2]), 1e-12f);
    s = fix_scale ? 1.f : num / den;
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = c2[i] - s * dot3(R[i], c1);
}

__global__ void __launch_bounds__(NT) sim3_hypotheses_kernel(
    const long long* __restrict__ samples, const float* __restrict__ x1,
    const float* __restrict__ x2, const float* __restrict__ uv1, const float* __restrict__ uv2,
    const uint8_t* __restrict__ valid, const float* __restrict__ is1,
    const float* __restrict__ is2, int H, int N, float fx, float fy, float cx, float cy, float th,
    int fix_scale, float* __restrict__ s_out, float* __restrict__ R_out,
    float* __restrict__ t_out, int* __restrict__ n_out, long long* __restrict__ best,
    unsigned* __restrict__ ticket) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_key, is_last;
    const Pairs P = stage(smem, N, x1, x2, uv1, uv2, valid, is1, is2);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int h = blockIdx.x * NWARP + (threadIdx.x >> 5);
    const int hs = min(h, H - 1);                      // past H: solve a copy, write nothing
    float p1[3][3], p2[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const long long raw = samples[(size_t)hs * 3 + k];
        const int i = (int)min(max(raw, 0ll), (long long)(N - 1));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            p1[k][c] = P.x1[3 * i + c];
            p2[k][c] = P.x2[3 * i + c];
        }
    }
    float s, R[3][3], t[3];
    horn3(p1, p2, fix_scale != 0, s, R, t);
    const float si = 1.f / s;
    float ti[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) ti[i] = -(si * ((R[0][i] * t[0] + R[1][i] * t[1]) + R[2][i] * t[2]));

    int cnt = 0;
    for (int n = lane; n < N; n += 32) {
        const float* a = P.x1 + 3 * n;
        const float* b = P.x2 + 3 * n;
        float y2[3], y1[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            y2[i] = s * ((a[0] * R[i][0] + a[1] * R[i][1]) + a[2] * R[i][2]) + t[i];
            y1[i] = si * ((b[0] * R[0][i] + b[1] * R[1][i]) + b[2] * R[2][i]) + ti[i];
        }
        const float z1 = fmaxf(y1[2], 1e-6f), z2 = fmaxf(y2[2], 1e-6f);
        const float du1 = (fx * y1[0] / z1 + cx) - P.uv1[2 * n];
        const float dv1 = (fy * y1[1] / z1 + cy) - P.uv1[2 * n + 1];
        const float du2 = (fx * y2[0] / z2 + cx) - P.uv2[2 * n];
        const float dv2 = (fy * y2[1] / z2 + cy) - P.uv2[2 * n + 1];
        const float e1 = (du1 * du1 + dv1 * dv1) * P.is1[n];
        const float e2 = (du2 * du2 + dv2 * dv2) * P.is2[n];
        cnt += (P.v[n] && e1 < th && e2 < th && y1[2] > 0.f && y2[2] > 0.f) ? 1 : 0;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
    if (h < H) {
        if (lane == 0) {
            s_out[h] = s;
            n_out[h] = cnt;
        }
        if (lane < 9) R_out[(size_t)h * 9 + lane] = R[lane / 3][lane % 3];
        if (lane < 3) t_out[(size_t)h * 3 + lane] = t[lane];
    }

    // the last CTA picks the first hypothesis with the most inliers
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
        s_key = -1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    int key = -1;
    for (int i = threadIdx.x; i < H; i += NT) key = max(key, (__ldcg(&n_out[i]) << 16) | (H - 1 - i));
    atomicMax(&s_key, key);
    __syncthreads();
    if (threadIdx.x == 0) {
        *best = H - 1 - (s_key & 0xffff);
        *ticket = 0u;
    }
}

// ticket [1] holds 0 between calls.
extern "C" int sim3_hypotheses_launch(const long long* samples, const float* x1, const float* x2,
                                      const float* uv1, const float* uv2, const uint8_t* valid,
                                      const float* is1, const float* is2, int H, int N, float fx,
                                      float fy, float cx, float cy, float th, int fix_scale,
                                      float* s, float* R, float* t, int* n, long long* best,
                                      unsigned* ticket, cudaStream_t stream) {
    if (N <= 0 || N > MAX_N || H <= 0 || H >= (1 << 15)) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)N * PAIR_BYTES;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sim3_hypotheses_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int grid = (H + NWARP - 1) / NWARP;
    sim3_hypotheses_kernel<<<grid, NT, smem, stream>>>(samples, x1, x2, uv1, uv2, valid, is1, is2,
                                                       H, N, fx, fy, cx, cy, th, fix_scale, s, R,
                                                       t, n, best, ticket);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 8
// ---------------------------------------------------------------------------

#define NACC 36              // H upper triangle (28), g (7), cost

struct Cam { float fx, fy, cx, cy; };

struct Sim { float s, R[9], t[3]; };

struct LmState {
    Sim cur, cand[3];
    float part[NWARP][NACC];
    float red[NACC];
    float cred[3];
    float lam;
    int n_inl;
};

__constant__ float c_ladder[3] = {1.0f, 8.0f, 64.0f};

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    return v;
}

template <int K>
__device__ __forceinline__ void block_sum(const float (&acc)[K], LmState& st, float* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const float s = warp_sum(acc[i]);
        if (lane == 0) st.part[warp][i] = s;
    }
    __syncthreads();
    if (threadIdx.x < K) {
        float s = 0.0f;
        for (int w = 0; w < NWARP; ++w) s += st.part[w][threadIdx.x];
        out[threadIdx.x] = s;
    }
    __syncthreads();
}

// One pair's forward point y2 = S x1 and inverse point y1 = S^-1 x2, their
// pixel residuals (scaled by sqrt(inv_sigma2)), chi2 and depth test, in
// project_residuals' terms.
struct PairRes {
    float y2[3], y1[3], z2, z1, r[4], cf, ci;
    bool dok;
};

__device__ __forceinline__ PairRes pair_res(const Cam& c, const Sim& S, const Pairs& P, int n) {
    PairRes o;
    const float* a = P.x1 + 3 * n;
    const float* b = P.x2 + 3 * n;
    const float si = 1.f / S.s;
    float ti[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) ti[i] = -si * ((S.R[i] * S.t[0] + S.R[3 + i] * S.t[1]) + S.R[6 + i] * S.t[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        o.y2[i] = S.s * ((a[0] * S.R[3 * i] + a[1] * S.R[3 * i + 1]) + a[2] * S.R[3 * i + 2]) + S.t[i];
        o.y1[i] = si * ((b[0] * S.R[i] + b[1] * S.R[3 + i]) + b[2] * S.R[6 + i]) + ti[i];
    }
    o.z2 = fmaxf(o.y2[2], 1e-6f);
    o.z1 = fmaxf(o.y1[2], 1e-6f);
    const float w2 = sqrtf(P.is2[n]), w1 = sqrtf(P.is1[n]);
    o.r[0] = ((c.fx * o.y2[0] / o.z2 + c.cx) - P.uv2[2 * n]) * w2;
    o.r[1] = ((c.fy * o.y2[1] / o.z2 + c.cy) - P.uv2[2 * n + 1]) * w2;
    o.r[2] = ((c.fx * o.y1[0] / o.z1 + c.cx) - P.uv1[2 * n]) * w1;
    o.r[3] = ((c.fy * o.y1[1] / o.z1 + c.cy) - P.uv1[2 * n + 1]) * w1;
    o.cf = o.r[0] * o.r[0] + o.r[1] * o.r[1];
    o.ci = o.r[2] * o.r[2] + o.r[3] * o.r[3];
    o.dok = o.y1[2] > 1e-3f && o.y2[2] > 1e-3f;
    return o;
}

__device__ __forceinline__ float pair_cost(const PairRes& e, float th) {
    const float chi2 = e.cf + e.ci;
    const float hub = chi2 > th ? 2.f * sqrtf(th * fmaxf(chi2, 0.f)) - th : chi2;
    return e.dok ? hub : 100.f * th;
}

// Accumulate one residual row: J [7] (already weighted), r (weighted).
__device__ __forceinline__ void add_row(float (&acc)[NACC], const float (&J)[7], float r) {
    int k = 0;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
#pragma unroll
        for (int j = i; j < 7; ++j) acc[k++] += J[i] * J[j];
        acc[28 + i] += J[i] * r;
    }
}

__device__ __forceinline__ void matmul3(const float* A, const float* B, float* out) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            out[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// S' = exp(xi) o S (lie.sim3_retract), xi = [rho, phi, sigma].
__device__ void sim3_retract(const float* xi, const Sim& S, Sim& out) {
    const float* rho = xi;
    const float* phi = xi + 3;
    const float sigma = xi[6];
    const float sq = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
    const float K[9] = {0.f, -phi[2], phi[1], phi[2], 0.f, -phi[0], -phi[1], phi[0], 0.f};
    float K2[9];
    matmul3(K, K, K2);
    // so3_exp
    const bool small = sq < 1e-8f;
    const float sq_safe = small ? 1.f : sq;
    const float x = sqrtf(sq_safe);
    const float a_ = small ? 1.f - sq / 6.f : sinf(x) / x;
    const float b_ = small ? 0.5f - sq / 24.f : (1.f - cosf(x)) / sq_safe;
    // the translation's W
    const float s = expf(sigma);
    const float theta = sqrtf(sq);
    const bool sig_small = fabsf(sigma) < 1e-5f, th_small = theta < 1e-5f;
    const float sig_safe = sig_small ? 1.f : sigma, th_safe = th_small ? 1.f : theta;
    const float C = sig_small ? 1.f + sigma / 2.f + sigma * sigma / 6.f : (s - 1.f) / sig_safe;
    const float bb = s * cosf(theta), aa = s * sinf(theta);
    const float den = sigma * sigma + theta * theta;
    const float den_safe = (th_small && sig_small) ? 1.f : den;
    float A, B;
    if (th_small) {
        A = sig_small ? 0.5f + sigma / 3.f : ((sig_safe - 1.f) * s + 1.f) / (sig_safe * sig_safe);
        B = sig_small ? 1.f / 6.f + sigma / 4.f
                      : ((0.5f * sig_safe * sig_safe - sig_safe + 1.f) * s - 1.f) /
                            (sig_safe * sig_safe * sig_safe);
    } else {
        A = (sigma * aa + (1.f - bb) * th_safe) / (th_safe * den_safe);
        B = (C - ((bb - 1.f) * sigma + aa * th_safe) / den_safe) / (th_safe * th_safe);
    }
    float dR[9], W[9], dt[3];
    for (int k = 0; k < 9; ++k) {
        const float eye = (k % 4 == 0) ? 1.f : 0.f;
        dR[k] = eye + a_ * K[k] + b_ * K2[k];
        W[k] = C * eye + A * K[k] + B * K2[k];
    }
    for (int i = 0; i < 3; ++i) dt[i] = W[3 * i] * rho[0] + W[3 * i + 1] * rho[1] + W[3 * i + 2] * rho[2];
    out.s = s * S.s;
    matmul3(dR, S.R, out.R);
    for (int i = 0; i < 3; ++i)
        out.t[i] = s * (dR[3 * i] * S.t[0] + dR[3 * i + 1] * S.t[1] + dR[3 * i + 2] * S.t[2]) + dt[i];
}

// Solve the 7x7 A x = b by Gaussian elimination with partial pivoting.
__device__ void solve7(float (&A)[7][7], float (&b)[7], float (&x)[7]) {
    for (int k = 0; k < 7; ++k) {
        int piv = k;
        float best = fabsf(A[k][k]);
        for (int i = k + 1; i < 7; ++i)
            if (fabsf(A[i][k]) > best) {
                best = fabsf(A[i][k]);
                piv = i;
            }
        if (piv != k) {
            for (int j = 0; j < 7; ++j) {
                const float tmp = A[k][j];
                A[k][j] = A[piv][j];
                A[piv][j] = tmp;
            }
            const float tb = b[k];
            b[k] = b[piv];
            b[piv] = tb;
        }
        for (int i = k + 1; i < 7; ++i) {
            const float f = A[i][k] / A[k][k];
            for (int j = k; j < 7; ++j) A[i][j] -= f * A[k][j];
            b[i] -= f * b[k];
        }
    }
    for (int i = 6; i >= 0; --i) {
        float v = b[i];
        for (int j = i + 1; j < 7; ++j) v -= A[i][j] * x[j];
        x[i] = v / A[i][i];
    }
}

__global__ void __launch_bounds__(NT) sim3_lm_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2, const float* __restrict__ uv1,
    const float* __restrict__ uv2, const uint8_t* __restrict__ valid,
    const float* __restrict__ is1, const float* __restrict__ is2, const float* __restrict__ s0,
    const float* __restrict__ R0, const float* __restrict__ t0, int N, Cam c, int fix_scale,
    int iters, float th, float* __restrict__ s_out, float* __restrict__ R_out,
    float* __restrict__ t_out, uint8_t* __restrict__ inlier_out, int* __restrict__ n_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ LmState st;
    const int tid = threadIdx.x;
    const Pairs P = stage(smem, N, x1, x2, uv1, uv2, valid, is1, is2);
    uint8_t* mask = P.v + N;
    for (int i = tid; i < N; i += NT) mask[i] = valid[i] ? 1 : 0;
    if (tid == 0) {
        st.cur.s = *s0;
        for (int k = 0; k < 9; ++k) st.cur.R[k] = R0[k];
        for (int k = 0; k < 3; ++k) st.cur.t[k] = t0[k];
        st.lam = 1e-4f;
        st.n_inl = 0;
    }
    __syncthreads();

    for (int it = 0; it < iters; ++it) {
        // (a) linearize at the current Sim3
        const Sim S = st.cur;
        const float si = 1.f / S.s;
        float acc[NACC];
#pragma unroll
        for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
        for (int n = tid; n < N; n += NT) {
            if (!mask[n]) continue;
            const PairRes e = pair_res(c, S, P, n);
            acc[35] += pair_cost(e, th);
            const float chi2 = e.cf + e.ci;
            const float wh = chi2 > th ? sqrtf(th / fmaxf(chi2, 1e-12f)) : 1.f;
            if (!e.dok) continue;
            const float w = sqrtf(wh);
            // forward: p = y2, dp/dxi = [I, -hat(p), p]
            {
                const float px = e.y2[0], py = e.y2[1], pz = e.y2[2], iz = 1.f / e.z2;
                const float ws = w * sqrtf(P.is2[n]);
                const float dP[3][7] = {{1.f, 0.f, 0.f, 0.f, pz, -py, px},
                                        {0.f, 1.f, 0.f, -pz, 0.f, px, py},
                                        {0.f, 0.f, 1.f, py, -px, 0.f, pz}};
                float Ju[7], Jv[7];
                for (int j = 0; j < 7; ++j) {
                    Ju[j] = ws * (c.fx * iz * dP[0][j] - c.fx * px * iz * iz * dP[2][j]);
                    Jv[j] = ws * (c.fy * iz * dP[1][j] - c.fy * py * iz * iz * dP[2][j]);
                }
                add_row(acc, Ju, w * e.r[0]);
                add_row(acc, Jv, w * e.r[1]);
            }
            // inverse: q = y1, dq/dxi = -(1/s) R^T [I, -hat(x2), x2]
            {
                const float* b = P.x2 + 3 * n;
                const float qx = e.y1[0], qy = e.y1[1], iz = 1.f / e.z1;
                const float ws = w * sqrtf(P.is1[n]);
                const float G[3][7] = {{1.f, 0.f, 0.f, 0.f, b[2], -b[1], b[0]},
                                       {0.f, 1.f, 0.f, -b[2], 0.f, b[0], b[1]},
                                       {0.f, 0.f, 1.f, b[1], -b[0], 0.f, b[2]}};
                float dQ[3][7];
                for (int i = 0; i < 3; ++i)
                    for (int j = 0; j < 7; ++j)
                        dQ[i][j] = -si * ((S.R[i] * G[0][j] + S.R[3 + i] * G[1][j]) + S.R[6 + i] * G[2][j]);
                float Ju[7], Jv[7];
                for (int j = 0; j < 7; ++j) {
                    Ju[j] = ws * (c.fx * iz * dQ[0][j] - c.fx * qx * iz * iz * dQ[2][j]);
                    Jv[j] = ws * (c.fy * iz * dQ[1][j] - c.fy * qy * iz * iz * dQ[2][j]);
                }
                add_row(acc, Ju, w * e.r[2]);
                add_row(acc, Jv, w * e.r[3]);
            }
        }
        block_sum<NACC>(acc, st, st.red);

        // (b) the damping ladder: one lane per lambda
        if (tid < 3) {
            float H[7][7], g[7], dx[7];
            int k = 0;
            for (int i = 0; i < 7; ++i)
                for (int j = i; j < 7; ++j) {
                    H[i][j] = st.red[k];
                    H[j][i] = st.red[k];
                    ++k;
                }
            for (int i = 0; i < 7; ++i) g[i] = st.red[28 + i];
            if (fix_scale) {
                for (int i = 0; i < 7; ++i) H[i][6] = H[6][i] = 0.f;
                H[6][6] = 1.f;
                g[6] = 0.f;
            }
            const float lam_k = st.lam * c_ladder[tid];
            for (int i = 0; i < 7; ++i) H[i][i] = (H[i][i] + lam_k * H[i][i]) + 1e-8f;
            solve7(H, g, dx);
            for (int i = 0; i < 7; ++i) dx[i] = -dx[i];
            if (fix_scale) dx[6] = 0.f;
            sim3_retract(dx, S, st.cand[tid]);
        }
        __syncthreads();

        // (c) the three candidates' costs
        float cacc[3] = {0.f, 0.f, 0.f};
        for (int n = tid; n < N; n += NT) {
            if (!mask[n]) continue;
#pragma unroll
            for (int k = 0; k < 3; ++k) cacc[k] += pair_cost(pair_res(c, st.cand[k], P, n), th);
        }
        block_sum<3>(cacc, st, st.cred);

        // (d) accept the first improving lambda
        if (tid == 0) {
            const float cost = st.red[35];
            int pick = -1;
            for (int k = 0; k < 3 && pick < 0; ++k)
                if (st.cred[k] < cost) pick = k;
            float lam;
            if (pick >= 0) {
                st.cur = st.cand[pick];
                lam = (st.lam * c_ladder[pick]) * 0.4f;
            } else {
                lam = st.lam * 512.f;
            }
            st.lam = fminf(fmaxf(lam, 1e-9f), 1e6f);
        }
        __syncthreads();

        // (e) chi2 inlier refresh at the accepted Sim3
        const Sim S2 = st.cur;
        for (int n = tid; n < N; n += NT) {
            bool inl = false;
            if (P.v[n]) {
                const PairRes e = pair_res(c, S2, P, n);
                inl = e.cf < th && e.ci < th && e.dok;
            }
            mask[n] = inl ? 1 : 0;
        }
        __syncthreads();
    }

    int cnt = 0;
    for (int n = tid; n < N; n += NT) {
        inlier_out[n] = mask[n];
        cnt += mask[n];
    }
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(FULL, cnt, o);
    if ((tid & 31) == 0) atomicAdd(&st.n_inl, cnt);
    __syncthreads();
    if (tid == 0) {
        *s_out = st.cur.s;
        for (int k = 0; k < 9; ++k) R_out[k] = st.cur.R[k];
        for (int k = 0; k < 3; ++k) t_out[k] = st.cur.t[k];
        *n_out = st.n_inl;
    }
}

extern "C" int sim3_lm_launch(const float* x1, const float* x2, const float* uv1, const float* uv2,
                              const uint8_t* valid, const float* is1, const float* is2,
                              const float* s0, const float* R0, const float* t0, int N, float fx,
                              float fy, float cx, float cy, int fix_scale, int iters, float th,
                              float* s, float* R, float* t, uint8_t* inlier, int* n,
                              cudaStream_t stream) {
    if (N <= 0 || N > MAX_N) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)N * (PAIR_BYTES + 1);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sim3_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    Cam c = {fx, fy, cx, cy};
    sim3_lm_kernel<<<1, NT, smem, stream>>>(x1, x2, uv1, uv2, valid, is1, is2, s0, R0, t0, N, c,
                                            fix_scale, iters, th, s, R, t, inlier, n);
    return (int)cudaGetLastError();
}
