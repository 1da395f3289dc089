// Kernel 12: local BA's grid LM (ba_core.bundle_adjust_grid), linearization
// to Cholesky, in 2 + 4 x iters launches of three kernels on one stream.
//
// Replaces (JAX reference): solvers/ba_core.py bundle_adjust_grid (:473-586)
// with its _grid_planes_residual_jac (:390), _grid_cost (:334),
// schur_solve_planes (:439), _inv3_planes (:364) and the se3 retraction of
// geometry/lie.py se3_retract.  What it computes is the port's plain twin
// ba_core.bundle_adjust_grid_plain: a robust LM over a [C <= 32, N] grid of
// keyframe features observing P points; each iteration one linearization
// and a ladder of three dampings lambda * {1, 8, 64}, each a Schur solve of
// the 6C x 6C camera system by Cholesky (the step all NaN where a pivot is
// not > 0, so never taken), a retraction and a cost over the grid; the first
// try that lowers the cost is kept; lambda x 0.3 of the kept value or x 512,
// clamped to [1e-9, 1e6].
//
// Bound: the dependency chain.  A 4-iteration solve at C = 32, N = 1024,
// P = 2048 is ~20 MFLOP on ~1.5 MB of inputs (a few us of the card), but
// each iteration is four dependent launches, three of them short of work
// (tools/k12_stages.py splits an iteration).  No tensor cores: the blocks
// are 6x6, 6x3 and 3x3, and the 192 x 192 factorization is 1.2 MFLOP.
//
// The launches of one solve (grid_ba_launch):
//   gba_grid SETUP (C + 1 CTAs): CTA c lists, for each point, camera c's
//       lowest valid slot observing it (inv [C][P], N for none: an
//       atomicMin over the camera's slots, whose result no order changes);
//       the last CTA copies the start state into the outputs, lambda, and
//       zeroes the pick's ticket.
//   per iteration:
//   gba_grid LIN (C camera CTAs + ceil(P / 256) point CTAs): a camera CTA
//       linearizes its N slots (a thread every 256th) and sums Hcc (upper 21),
//       gc and the cost over base_valid; a point thread gathers its <= C
//       observations in camera order (the inv slots only, so a duplicate
//       (point, camera) slot of fuse counts once, as the twin's amin
//       index) into Hpp, gp, the B_pc blocks and a camera bit mask, then
//       inverts its three damped Hpp blocks (closed form, det guard).
//   gba_schur ((C, 3) CTAs): CTA (c, k) of a free camera c compacts the
//       points camera c sees (ascending), stages BH = B_pc Hpp_k^-1 in shared
//       memory, and a warp per free d <= c sums S_cd = -sum_p BH B_pd^T over
//       those that d sees too (a lane every 32nd point, then an xor
//       butterfly); the diagonal warp adds the damped Hcc and forms the
//       right-hand side -gc + sum_p BH gp.
//   gba_chol (3 CTAs): CTA k assembles the reduced system's lower triangle
//       (cameras not free held by identity rows, padded to a multiple of 16)
//       in shared memory (147,456 B at C = 32), factors it by 16-column
//       blocks (a warp the diagonal block, a thread a panel row, the
//       trailing update a thread an entry: three barriers a block), solves
//       both triangles blockwise, retracts the cameras and back-substitutes
//       every point's step.
//   gba_grid TRIES ((C, 3) CTAs): each try's cost over a camera's slots
//       (edge_valid, as the twin's grid_cost); the last CTA (a ticket) adds
//       the 3 x C partials in camera order, picks the first improving try,
//       updates the state, lambda and the returned cost.
//   gba_grid FINAL (C CTAs): the inlier mask at the final state.
//
// Numerics: --fmad=false, IEEE division and square roots, each expression
// in the twin's order, its three-term einsums and matrix products as cuBLAS
// takes them (dot3: a product, then two fused multiply-adds).  Sums run in orders fixed by the shapes (a thread's
// slots in order, xor butterflies, warps in order, cameras in order), so two
// calls give the same bits, but not the twin's (cuBLAS / reduction) orders:
// the tolerances are in chip_smoke.py.  No float atomics, no allocation, no
// host read: the wrapper allocates one workspace a call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CHI2_MONO 5.991f
#define CHI2_STEREO 7.815f
#define FULL 0xffffffffu
#define MAX_C 32
#define NB 16                // the Cholesky's block
#define GRID_THREADS 256     // a camera CTA of gba_grid
#define SCHUR_THREADS 256
#define CHOL_THREADS 512
#define LIST_BYTES 80        // gba_schur's shared memory a listed point: index, mask, BH
#define DYN_SMEM (232448 - 1024)   // dynamic shared memory a CTA may take beside 1 KB of static

enum Mode { SETUP = 0, LIN = 1, TRIES = 2, FINAL = 3 };

struct Cam { float fx, fy, cx, cy, bf; };

struct Prob {
    const float *R0, *t0, *X0;
    const uint8_t *cam_fixed, *cam_valid, *pt_valid;
    const int* pt_loc;
    const float *uv, *ur, *is2;
    const uint8_t* edge_valid;
    int C, N, P, robust;
    float ladder[3];
};

// The workspace of one call (layout() below lays it out).
struct Work {
    int* inv;          // [C][P] camera c's lowest valid slot n observing p; N for none
    unsigned* mask;    // [P] the cameras with an inv slot
    float* Hcc;        // [C][21] upper triangle, row by row
    float* gc;         // [C][6]
    float* cost_lin;   // [C] the linearization point's cost over base_valid
    float* B;          // [C][18][P] B_pc (entry i * 3 + k), only where the bit is set
    float* gp;         // [3][P]
    float* Hinv;       // [3][9][P] the damped Hpp's inverse, per ladder value
    float* S;          // [3][C][C][36] S_cd (row-major 6x6) for c >= d, both free
    float* rhs;        // [3][C][6]
    float *R_a, *t_a, *X_a;   // the tries: [3][C][9], [3][C][3], [3][P][3]
    float* cost_try;   // [3][C]
    int* fail;         // [3] a pivot not > 0
    float* lam;        // [1]
    unsigned* ticket;  // [1] 0 between launches
    float* Hpp;        // [6][P] upper triangle (for the checks)
    float* dc;         // [3][6C] each ladder value's camera step (for the checks)
};

struct Out { float *R, *t, *X; uint8_t* inlier; float* cost; };

// The three-term dot products the twin takes from its einsums and matrix
// products (cuBLAS: a product, then two fused multiply-adds in order).
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
    return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, a0 * b0));
}

__device__ __forceinline__ bool cam_free(const Prob& pb, int c) {
    return pb.cam_valid[c] && !pb.cam_fixed[c];
}

// Index of (i, j), i <= j, in a row-by-row upper triangle of a 6x6 matrix.
__device__ __forceinline__ int up6(int i, int j) { return i * 6 - i * (i - 1) / 2 + (j - i); }

// One slot's weighted linearization as grid_residual_jac and linearize
// compute it: sqrt(w) folded into Jc (zero on a fixed camera), Jp and r;
// the huberized cost term (before its mask).
struct SlotLin {
    float Jc[3][6], Jp[3][3], r[3], hub;
};

__device__ __forceinline__ void slot_lin(const Cam& cm, const float* Rc, const float* tc,
                                         float X0, float X1, float X2, float u0, float v0,
                                         float ur, float is2, bool bv, bool fixed, bool robust,
                                         SlotLin& o) {
    const float x = dot3(Rc[0], X0, Rc[1], X1, Rc[2], X2) + tc[0];
    const float y = dot3(Rc[3], X0, Rc[4], X1, Rc[5], X2) + tc[1];
    const float z = dot3(Rc[6], X0, Rc[7], X1, Rc[8], X2) + tc[2];
    const bool depth_ok = z > 1e-3f;
    const float zs = z < 1e-3f ? 1e-3f : z;
    const float iz = 1.0f / zs;
    const float iz2 = iz * iz;
    const float u = cm.fx * x * iz + cm.cx;
    const float v = cm.fy * y * iz + cm.cy;
    const float ur_pred = u - cm.bf * iz;
    const bool st = ur >= 0.0f;
    const float r[3] = {u - u0, v - v0, st ? ur_pred - ur : 0.0f};
    const float du0 = cm.fx * iz, du2 = -cm.fx * x * iz2;
    const float d[3][3] = {{du0, 0.0f, du2},
                           {0.0f, cm.fy * iz, -cm.fy * y * iz2},
                           {st ? du0 : 0.0f, 0.0f, st ? du2 + cm.bf * iz2 : 0.0f}};
    const float chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * is2;
    const float delta2 = st ? CHI2_STEREO : CHI2_MONO;
    float wh = 1.0f;
    if (robust && chi2 > delta2) wh = sqrtf(delta2 / fmaxf(chi2, 1e-12f));
    const float w = is2 * wh * ((bv && depth_ok) ? 1.0f : 0.0f);
    const float sw = sqrtf(w);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        const float dx = d[q][0], dy = d[q][1], dz = d[q][2];
        const float jc[6] = {dx, dy, dz, dz * y - dy * z, dx * z - dz * x, dy * x - dx * y};
#pragma unroll
        for (int i = 0; i < 6; ++i) o.Jc[q][i] = (fixed ? 0.0f : jc[i]) * sw;
#pragma unroll
        for (int j = 0; j < 3; ++j)
            o.Jp[q][j] = dot3(dx, Rc[j], dy, Rc[3 + j], dz, Rc[6 + j]) * sw;
        o.r[q] = r[q] * sw;
    }
    const float hub = chi2 > delta2 ? 2.0f * sqrtf(delta2 * fmaxf(chi2, 0.0f)) - delta2 : chi2;
    o.hub = depth_ok ? hub : 100.0f * delta2;
}

// One slot's huberized cost as grid_cost computes it (divisions by z):
// returns the term, with its chi2, gate and depth test.
__device__ __forceinline__ float slot_cost(const Cam& cm, const float* Rc, const float* tc,
                                           float X0, float X1, float X2, float u0, float v0,
                                           float ur, float is2, float& chi2, float& delta2,
                                           bool& depth_ok) {
    const float x = dot3(Rc[0], X0, Rc[1], X1, Rc[2], X2) + tc[0];
    const float y = dot3(Rc[3], X0, Rc[4], X1, Rc[5], X2) + tc[1];
    const float z = dot3(Rc[6], X0, Rc[7], X1, Rc[8], X2) + tc[2];
    depth_ok = z > 1e-3f;
    const float zs = z < 1e-3f ? 1e-3f : z;
    const float u = cm.fx * x / zs + cm.cx;
    const float v = cm.fy * y / zs + cm.cy;
    const float ur_pred = u - cm.bf / zs;
    const bool st = ur >= 0.0f;
    const float du = u - u0, dv = v - v0, dr = ur_pred - ur;
    const float e2 = du * du + dv * dv + (st ? dr * dr : 0.0f);
    chi2 = e2 * is2;
    delta2 = st ? CHI2_STEREO : CHI2_MONO;
    const float hub = chi2 > delta2 ? 2.0f * sqrtf(delta2 * fmaxf(chi2, 0.0f)) - delta2 : chi2;
    return depth_ok ? hub : 100.0f * delta2;
}

// Sum K values over a CTA: an xor butterfly in each warp, then the warps'
// sums in warp order by thread j < K; out[j] (shared or global) written by
// that thread.  `red` holds NW * K floats of shared memory.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red, float* out) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
#pragma unroll
    for (int j = 0; j < K; ++j)
        for (int o = 16; o > 0; o >>= 1) v[j] += __shfl_xor_sync(FULL, v[j], o);
    if (lane == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) red[warp * K + j] = v[j];
    }
    __syncthreads();
    if (tid < K) {
        float s = red[tid];
        for (int w = 1; w < nw; ++w) s += red[w * K + tid];
        out[tid] = s;
    }
}

// (R, t) <- exp(xi) o (R, t), xi = [rho, phi] (lie.se3_retract), by one
// thread: P and out hold R row-major, then t.
__device__ void se3_retract(const float* xi, const float* P, float* out) {
    const float rho0 = xi[0], rho1 = xi[1], rho2 = xi[2];
    const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
    const float sq = p0 * p0 + p1 * p1 + p2 * p2;
    const float K[9] = {0.0f, -p2, p1, p2, 0.0f, -p0, -p1, p0, 0.0f};
    const bool small = sq < 1e-8f;
    const float sq_safe = small ? 1.0f : sq;
    const float th = sqrtf(sq_safe);
    const float sn = sinf(th), cs = cosf(th);
    const float a = small ? 1.0f - sq / 6.0f : sn / th;
    const float b = small ? 0.5f - sq / 24.0f : (1.0f - cs) / sq_safe;
    const float cc = small ? (float)(1.0 / 6.0) - sq / 120.0f : (th - sn) / (th * sq_safe);
    float dR[9], J[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            const float K2 = dot3(K[3 * i], K[m], K[3 * i + 1], K[3 + m], K[3 * i + 2], K[6 + m]);
            const float eye = m == i ? 1.0f : 0.0f;
            dR[3 * i + m] = eye + a * K[3 * i + m] + b * K2;
            J[3 * i + m] = eye + b * K[3 * i + m] + cc * K2;
        }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
            out[3 * i + j] = dot3(dR[3 * i], P[j], dR[3 * i + 1], P[3 + j], dR[3 * i + 2], P[6 + j]);
        const float Rt = dot3(dR[3 * i], P[9], dR[3 * i + 1], P[10], dR[3 * i + 2], P[11]);
        const float dt = dot3(J[3 * i], rho0, J[3 * i + 1], rho1, J[3 * i + 2], rho2);
        out[9 + i] = Rt + dt;
    }
}

// ---- gba_grid: SETUP, LIN, TRIES and FINAL (the CTA's role from blockIdx)

__device__ void setup_cta(const Prob& pb, const Work& wk, const Out& o, float lam0) {
    const int C = pb.C, N = pb.N, P = pb.P, c = blockIdx.x, tid = threadIdx.x;
    if (c == C) {               // the start state, lambda, the ticket
        for (int i = tid; i < 9 * C; i += blockDim.x) o.R[i] = pb.R0[i];
        for (int i = tid; i < 3 * C; i += blockDim.x) o.t[i] = pb.t0[i];
        for (int i = tid; i < 3 * P; i += blockDim.x) o.X[i] = pb.X0[i];
        if (tid == 0) {
            wk.lam[0] = lam0;
            wk.ticket[0] = 0u;
        }
        return;
    }
    int* inv = wk.inv + (size_t)c * P;
    for (int p = tid; p < P; p += blockDim.x) inv[p] = N;
    __syncthreads();
    for (int n = tid; n < N; n += blockDim.x) {
        const int s = c * N + n, loc = pb.pt_loc[s];
        if (pb.edge_valid[s] && loc >= 0 && loc < P) atomicMin(&inv[loc], n);
    }
}

__device__ void lin_camera_cta(const Cam& cm, const Prob& pb, const Work& wk, const Out& o,
                               float* red) {
    const int N = pb.N, c = blockIdx.x;
    __shared__ float Rt[12];
    if (threadIdx.x < 9) Rt[threadIdx.x] = o.R[9 * c + threadIdx.x];
    else if (threadIdx.x < 12) Rt[threadIdx.x] = o.t[3 * c + threadIdx.x - 9];
    __syncthreads();
    const bool fixed = pb.cam_fixed[c];
    float acc[28];
#pragma unroll
    for (int j = 0; j < 28; ++j) acc[j] = 0.0f;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        const int s = c * N + n, loc = pb.pt_loc[s];
        const bool bv = pb.edge_valid[s] && loc >= 0;
        const float* X = o.X + 3 * (size_t)(loc > 0 ? loc : 0);
        SlotLin L;
        slot_lin(cm, Rt, Rt + 9, X[0], X[1], X[2], pb.uv[2 * s], pb.uv[2 * s + 1], pb.ur[s],
                 pb.is2[s], bv, fixed, pb.robust, L);
        int q = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = i; j < 6; ++j)
                acc[q++] += (L.Jc[0][i] * L.Jc[0][j] + L.Jc[1][i] * L.Jc[1][j]) + L.Jc[2][i] * L.Jc[2][j];
#pragma unroll
        for (int i = 0; i < 6; ++i)
            acc[21 + i] += (L.Jc[0][i] * L.r[0] + L.Jc[1][i] * L.r[1]) + L.Jc[2][i] * L.r[2];
        acc[27] += L.hub * (bv ? 1.0f : 0.0f);
    }
    __shared__ float sums[28];
    block_sum<28>(acc, red, sums);
    __syncthreads();
    const int tid = threadIdx.x;
    if (tid < 21) wk.Hcc[21 * c + tid] = sums[tid];
    else if (tid < 27) wk.gc[6 * c + tid - 21] = sums[tid];
    else if (tid == 27) wk.cost_lin[c] = sums[27];
}

__device__ void lin_point_cta(const Cam& cm, const Prob& pb, const Work& wk, const Out& o) {
    const int C = pb.C, N = pb.N, P = pb.P;
    __shared__ float Rts[MAX_C * 12];
    __shared__ uint8_t fixed_s[MAX_C];
    for (int i = threadIdx.x; i < 12 * C; i += blockDim.x) {
        const int c = i / 12, e = i % 12;
        Rts[i] = e < 9 ? o.R[9 * c + e] : o.t[3 * c + e - 9];
    }
    for (int c = threadIdx.x; c < C; c += blockDim.x) fixed_s[c] = pb.cam_fixed[c];
    __syncthreads();
    const int p = (blockIdx.x - C) * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const float X0 = o.X[3 * p], X1 = o.X[3 * p + 1], X2 = o.X[3 * p + 2];
    float H[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, g[3] = {0.0f, 0.0f, 0.0f};
    unsigned m = 0u;
    for (int c = 0; c < C; ++c) {
        const int n = wk.inv[(size_t)c * P + p];
        if (n >= N) continue;
        m |= 1u << c;
        const int s = c * N + n;
        SlotLin L;
        slot_lin(cm, Rts + 12 * c, Rts + 12 * c + 9, X0, X1, X2, pb.uv[2 * s], pb.uv[2 * s + 1],
                 pb.ur[s], pb.is2[s], true, fixed_s[c], pb.robust, L);
        int q = 0;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
            for (int k = j; k < 3; ++k)
                H[q++] += (L.Jp[0][j] * L.Jp[0][k] + L.Jp[1][j] * L.Jp[1][k]) + L.Jp[2][j] * L.Jp[2][k];
            g[j] += (L.Jp[0][j] * L.r[0] + L.Jp[1][j] * L.r[1]) + L.Jp[2][j] * L.r[2];
        }
        float* Bc = wk.B + (size_t)c * 18 * P + p;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int k = 0; k < 3; ++k)
                Bc[(size_t)(3 * i + k) * P] =
                    dot3(L.Jc[0][i], L.Jp[0][k], L.Jc[1][i], L.Jp[1][k], L.Jc[2][i], L.Jp[2][k]);
    }
    wk.mask[p] = m;
#pragma unroll
    for (int j = 0; j < 3; ++j) wk.gp[(size_t)j * P + p] = g[j];
#pragma unroll
    for (int q = 0; q < 6; ++q) wk.Hpp[(size_t)q * P + p] = H[q];
    // H upper: 0 (0,0) 1 (0,1) 2 (0,2) 3 (1,1) 4 (1,2) 5 (2,2)
    const float lam = wk.lam[0];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float lk = lam * pb.ladder[k];
        const float a = (H[0] + (lk * H[0] + 1e-9f)) + 1e-8f;
        const float e = (H[3] + (lk * H[3] + 1e-9f)) + 1e-8f;
        const float i = (H[5] + (lk * H[5] + 1e-9f)) + 1e-8f;
        const float b = H[1], c = H[2], d = H[1], f = H[4], gg = H[2], h = H[4];
        const float co[9] = {e * i - f * h, c * h - b * i, b * f - c * e,
                             f * gg - d * i, a * i - c * gg, c * d - a * f,
                             d * h - e * gg, b * gg - a * h, a * e - b * d};
        const float det = a * co[0] + b * co[3] + c * co[6];
        const float det_safe = fabsf(det) < 1e-20f ? (det < 0.0f ? -1e-20f : 1e-20f) : det;
        float* Hi = wk.Hinv + (size_t)k * 9 * P + p;
#pragma unroll
        for (int q = 0; q < 9; ++q) Hi[(size_t)q * P] = co[q] / det_safe;
    }
}

__device__ void tries_cta(const Cam& cm, const Prob& pb, const Work& wk, const Out& o,
                          float* red) {
    const int C = pb.C, N = pb.N, P = pb.P, c = blockIdx.x % C, k = blockIdx.x / C;
    const int tid = threadIdx.x;
    const float* Rk = wk.R_a + (size_t)(k * C + c) * 9;
    const float* tk = wk.t_a + (size_t)(k * C + c) * 3;
    const float* Xk = wk.X_a + (size_t)k * P * 3;
    float acc[1] = {0.0f};
    for (int n = tid; n < N; n += blockDim.x) {
        const int s = c * N + n, loc = pb.pt_loc[s];
        const float* X = Xk + 3 * (size_t)(loc > 0 ? loc : 0);
        float chi2, delta2;
        bool dok;
        const float hub = slot_cost(cm, Rk, tk, X[0], X[1], X[2], pb.uv[2 * s], pb.uv[2 * s + 1],
                                    pb.ur[s], pb.is2[s], chi2, delta2, dok);
        acc[0] += hub * (pb.edge_valid[s] ? 1.0f : 0.0f);
    }
    block_sum<1>(acc, red, wk.cost_try + k * C + c);
    // the last CTA picks (its ticket after every CTA's partial is out)
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(wk.ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    __shared__ int s_pick;
    if (tid == 0) {
        float cost = __ldcg(wk.cost_lin);
        for (int d = 1; d < C; ++d) cost += __ldcg(wk.cost_lin + d);
        int pick = -1;
        float cost_new = cost;
        for (int kk = 0; kk < 3 && pick < 0; ++kk) {
            float ca = __ldcg(wk.cost_try + kk * C);
            for (int d = 1; d < C; ++d) ca += __ldcg(wk.cost_try + kk * C + d);
            if (!__ldcg(wk.fail + kk) && ca < cost) {
                pick = kk;
                cost_new = ca;
            }
        }
        const float lam = wk.lam[0];
        const float lam_new = pick >= 0 ? (lam * pb.ladder[pick]) * 0.3f : lam * 512.0f;
        wk.lam[0] = fminf(fmaxf(lam_new, 1e-9f), 1e6f);
        o.cost[0] = cost_new;
        wk.ticket[0] = 0u;
        s_pick = pick;
    }
    __syncthreads();
    const int pick = s_pick;
    if (pick < 0) return;
    for (int i = tid; i < 9 * C; i += blockDim.x) o.R[i] = wk.R_a[(size_t)pick * 9 * C + i];
    for (int i = tid; i < 3 * C; i += blockDim.x) o.t[i] = wk.t_a[(size_t)pick * 3 * C + i];
    for (int i = tid; i < 3 * P; i += blockDim.x) o.X[i] = wk.X_a[(size_t)pick * 3 * P + i];
}

__device__ void final_cta(const Cam& cm, const Prob& pb, const Out& o) {
    const int N = pb.N, c = blockIdx.x;
    __shared__ float Rt[12];
    if (threadIdx.x < 9) Rt[threadIdx.x] = o.R[9 * c + threadIdx.x];
    else if (threadIdx.x < 12) Rt[threadIdx.x] = o.t[3 * c + threadIdx.x - 9];
    __syncthreads();
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
        const int s = c * N + n, loc = pb.pt_loc[s];
        const bool bv = pb.edge_valid[s] && loc >= 0;
        const float* X = o.X + 3 * (size_t)(loc > 0 ? loc : 0);
        float chi2, delta2;
        bool dok;
        slot_cost(cm, Rt, Rt + 9, X[0], X[1], X[2], pb.uv[2 * s], pb.uv[2 * s + 1], pb.ur[s],
                  pb.is2[s], chi2, delta2, dok);
        o.inlier[s] = (bv && chi2 <= delta2 && dok) ? 1 : 0;
    }
}

__global__ void __launch_bounds__(GRID_THREADS) gba_grid(Cam cm, Prob pb, Work wk, Out o, int mode,
                                                         float lam0) {
    __shared__ float red[(GRID_THREADS / 32) * 28];
    if (mode == SETUP) {
        setup_cta(pb, wk, o, lam0);
    } else if (mode == LIN) {
        if ((int)blockIdx.x < pb.C) lin_camera_cta(cm, pb, wk, o, red);
        else lin_point_cta(cm, pb, wk, o);
    } else if (mode == TRIES) {
        tries_cta(cm, pb, wk, o, red);
    } else {
        final_cta(cm, pb, o);
    }
}

// ---- gba_schur: the Schur blocks of camera c's row for ladder value k

__global__ void __launch_bounds__(SCHUR_THREADS) gba_schur(Prob pb, Work wk, int cap) {
    constexpr int NW = SCHUR_THREADS / 32;
    const int C = pb.C, P = pb.P, c = blockIdx.x, k = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (!cam_free(pb, c)) return;
    extern __shared__ __align__(16) unsigned char sm[];
    int* list = reinterpret_cast<int*>(sm);                 // [cap] the points c sees, ascending
    unsigned* msk = reinterpret_cast<unsigned*>(list + cap);  // [cap] their camera masks
    float* BH = reinterpret_cast<float*>(msk + cap);         // [18][cap] B_pc Hpp_k^-1
    __shared__ int wcnt[NW];

    // the points with bit c, in order: warp w ballots points [w * per, (w + 1) * per)
    const int per = (P + NW - 1) / NW, s0 = min(P, warp * per), s1 = min(P, s0 + per);
    const unsigned bit_c = 1u << c;
    int cnt = 0;
    for (int s = s0; s < s1; s += 32) {
        const bool v = s + lane < s1 && (wk.mask[s + lane] & bit_c);
        cnt += __popc(__ballot_sync(FULL, v));
    }
    if (lane == 0) wcnt[warp] = cnt;
    __syncthreads();
    int base = 0, total = 0;
    for (int w = 0; w < NW; ++w) {
        base += w < warp ? wcnt[w] : 0;
        total += wcnt[w];
    }
    for (int s = s0; s < s1; s += 32) {
        const unsigned m = s + lane < s1 ? wk.mask[s + lane] : 0u;
        const bool v = (m & bit_c) != 0u;
        const unsigned bal = __ballot_sync(FULL, v);
        if (v) {
            const int idx = base + __popc(bal & ((1u << lane) - 1u));
            list[idx] = s + lane;
            msk[idx] = m;
        }
        base += __popc(bal);
    }
    __syncthreads();
    const float* Bc = wk.B + (size_t)c * 18 * P;
    const float* Hi = wk.Hinv + (size_t)k * 9 * P;
    for (int idx = tid; idx < total; idx += SCHUR_THREADS) {
        const int p = list[idx];
        float b[18], h[9];
#pragma unroll
        for (int q = 0; q < 18; ++q) b[q] = Bc[(size_t)q * P + p];
#pragma unroll
        for (int q = 0; q < 9; ++q) h[q] = Hi[(size_t)q * P + p];
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j)
                BH[(3 * i + j) * cap + idx] =
                    dot3(b[3 * i], h[j], b[3 * i + 1], h[3 + j], b[3 * i + 2], h[6 + j]);
    }
    __syncthreads();

    const float lk = wk.lam[0] * pb.ladder[k];
    for (int d = warp; d <= c; d += NW) {
        if (!cam_free(pb, d)) continue;
        const bool diag = d == c;
        const unsigned bit_d = 1u << d;
        const float* Bd = wk.B + (size_t)d * 18 * P;
        float acc[36], racc[6];
#pragma unroll
        for (int e = 0; e < 36; ++e) acc[e] = 0.0f;
#pragma unroll
        for (int i = 0; i < 6; ++i) racc[i] = 0.0f;
        for (int idx = lane; idx < total; idx += 32) {
            if (!(msk[idx] & bit_d)) continue;
            const int p = list[idx];
            float bh[18], bd[18];
#pragma unroll
            for (int q = 0; q < 18; ++q) {
                bh[q] = BH[q * cap + idx];
                bd[q] = Bd[(size_t)q * P + p];
            }
#pragma unroll
            for (int i = 0; i < 6; ++i)
#pragma unroll
                for (int l = 0; l < 6; ++l)
                    acc[6 * i + l] += (bh[3 * i] * bd[3 * l] + bh[3 * i + 1] * bd[3 * l + 1]) +
                                      bh[3 * i + 2] * bd[3 * l + 2];
            if (diag) {
                const float g0 = wk.gp[p], g1 = wk.gp[(size_t)P + p], g2 = wk.gp[2 * (size_t)P + p];
#pragma unroll
                for (int i = 0; i < 6; ++i)
                    racc[i] += (bh[3 * i] * g0 + bh[3 * i + 1] * g1) + bh[3 * i + 2] * g2;
            }
        }
#pragma unroll
        for (int e = 0; e < 36; ++e)
            for (int o = 16; o > 0; o >>= 1) acc[e] += __shfl_xor_sync(FULL, acc[e], o);
        if (diag) {
#pragma unroll
            for (int i = 0; i < 6; ++i)
                for (int o = 16; o > 0; o >>= 1) racc[i] += __shfl_xor_sync(FULL, racc[i], o);
        }
        if (lane == 0) {
            float* S = wk.S + ((size_t)(k * C + c) * C + d) * 36;
            const float* Hc = wk.Hcc + 21 * c;
#pragma unroll
            for (int i = 0; i < 6; ++i)
#pragma unroll
                for (int l = 0; l < 6; ++l) {
                    float hd = 0.0f;
                    if (diag) {
                        const float h = Hc[up6(min(i, l), max(i, l))];
                        hd = i == l ? h + (lk * h + 1e-9f) : h;
                    }
                    S[6 * i + l] = diag ? hd - acc[6 * i + l] : -acc[6 * i + l];
                }
            if (diag) {
                float* r = wk.rhs + (size_t)(k * C + c) * 6;
#pragma unroll
                for (int i = 0; i < 6; ++i) r[i] = -wk.gc[6 * c + i] + racc[i];
            }
        }
    }
}

// ---- gba_chol: ladder value k's reduced system, its step, its try

__global__ void __launch_bounds__(CHOL_THREADS) gba_chol(Prob pb, Work wk, Out o) {
    const int C = pb.C, P = pb.P, k = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n = 6 * C, nb = (n + NB - 1) / NB, np = nb * NB, lda = np + 1;
    extern __shared__ __align__(16) float A[];   // [np][lda] lower triangle
    float* v = A + (size_t)np * lda;             // [np] right-hand side, then the step
    __shared__ uint8_t fr[MAX_C];
    __shared__ int s_fail;
    if (tid < C) fr[tid] = cam_free(pb, tid) ? 1 : 0;
    if (tid == 0) s_fail = 0;
    __syncthreads();

    // assemble: S_cd for free c >= d, identity rows for the rest and the padding
    const float* S = wk.S + (size_t)k * C * C * 36;
    for (int idx = tid; idx < np * np; idx += CHOL_THREADS) {
        const int i = idx / np, j = idx % np;
        if (j > i) continue;
        float val = i == j ? 1.0f : 0.0f;
        if (i < n && fr[i / 6] && fr[j / 6])
            val = S[((size_t)(i / 6) * C + j / 6) * 36 + (i % 6) * 6 + (j % 6)];
        A[i * lda + j] = val;
    }
    for (int i = tid; i < np; i += CHOL_THREADS)
        v[i] = i < n && fr[i / 6] ? wk.rhs[(size_t)(k * C + i / 6) * 6 + i % 6] : 0.0f;
    __syncthreads();

    // factor: A = L L^T by blocks of NB columns
    for (int kb = 0; kb < nb; ++kb) {
        const int k0 = kb * NB;
        if (warp == 0) {
            for (int j = 0; j < NB; ++j) {
                float* Aj = A + (k0 + j) * lda + k0;
                const float piv = Aj[j];
                const float ljj = sqrtf(piv);
                __syncwarp();
                if (lane == 0) {
                    if (!(piv > 0.0f)) s_fail = 1;
                    Aj[j] = ljj;
                }
                if (lane > j && lane < NB) A[(k0 + lane) * lda + k0 + j] /= ljj;
                __syncwarp();
                if (lane > j && lane < NB) {
                    float* Ai = A + (k0 + lane) * lda + k0;
                    const float lij = Ai[j];
                    for (int m = j + 1; m <= lane; ++m) Ai[m] -= lij * A[(k0 + m) * lda + k0 + j];
                }
                __syncwarp();
            }
        }
        __syncthreads();
        const int r0 = k0 + NB, T = np - r0;
        for (int r = tid; r < T; r += CHOL_THREADS) {
            float* Ai = A + (r0 + r) * lda + k0;
            float x[NB];
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                const float* Lj = A + (k0 + j) * lda + k0;
                float s = Ai[j];
#pragma unroll
                for (int m = 0; m < j; ++m) s -= x[m] * Lj[m];
                x[j] = s / Lj[j];
                Ai[j] = x[j];
            }
        }
        __syncthreads();
        for (int idx = tid; idx < T * T; idx += CHOL_THREADS) {
            const int r = idx / T, q = idx % T;
            if (q > r) continue;
            const float* Li = A + (r0 + r) * lda + k0;
            const float* Lq = A + (r0 + q) * lda + k0;
            float s = A[(r0 + r) * lda + r0 + q];
#pragma unroll
            for (int m = 0; m < NB; ++m) s -= Li[m] * Lq[m];
            A[(r0 + r) * lda + r0 + q] = s;
        }
        __syncthreads();
    }

    // L y = v, then L^T x = y, by blocks
    for (int kb = 0; kb < nb; ++kb) {
        const int k0 = kb * NB;
        if (warp == 0) {
            float vi = lane < NB ? v[k0 + lane] : 0.0f;
            for (int j = 0; j < NB; ++j) {
                const float yj = __shfl_sync(FULL, vi, j) / A[(k0 + j) * lda + k0 + j];
                if (lane == j) vi = yj;
                if (lane > j && lane < NB) vi -= A[(k0 + lane) * lda + k0 + j] * yj;
            }
            if (lane < NB) v[k0 + lane] = vi;
        }
        __syncthreads();
        for (int i = k0 + NB + tid; i < np; i += CHOL_THREADS) {
            float s = v[i];
#pragma unroll
            for (int m = 0; m < NB; ++m) s -= A[i * lda + k0 + m] * v[k0 + m];
            v[i] = s;
        }
        __syncthreads();
    }
    for (int kb = nb - 1; kb >= 0; --kb) {
        const int k0 = kb * NB;
        if (warp == 0) {
            float vi = lane < NB ? v[k0 + lane] : 0.0f;
            for (int j = NB - 1; j >= 0; --j) {
                const float xj = __shfl_sync(FULL, vi, j) / A[(k0 + j) * lda + k0 + j];
                if (lane == j) vi = xj;
                if (lane < j) vi -= A[(k0 + j) * lda + k0 + lane] * xj;
            }
            if (lane < NB) v[k0 + lane] = vi;
        }
        __syncthreads();
        for (int i = tid; i < k0; i += CHOL_THREADS) {
            float s = v[i];
#pragma unroll
            for (int m = 0; m < NB; ++m) s -= A[(k0 + m) * lda + i] * v[k0 + m];
            v[i] = s;
        }
        __syncthreads();
    }

    // the step: NaN where the factorization failed, 0 on the cameras not free
    const bool failed = s_fail != 0;
    for (int i = tid; i < n; i += CHOL_THREADS) {
        v[i] = fr[i / 6] ? (failed ? __int_as_float(0x7fc00000) : v[i]) : 0.0f;
        wk.dc[(size_t)k * n + i] = v[i];
    }
    __syncthreads();
    if (tid < C) {
        float Pc[12], out[12];
#pragma unroll
        for (int e = 0; e < 9; ++e) Pc[e] = o.R[9 * tid + e];
#pragma unroll
        for (int e = 0; e < 3; ++e) Pc[9 + e] = o.t[3 * tid + e];
        se3_retract(v + 6 * tid, Pc, out);
        float* Ra = wk.R_a + (size_t)(k * C + tid) * 9;
        float* ta = wk.t_a + (size_t)(k * C + tid) * 3;
#pragma unroll
        for (int e = 0; e < 9; ++e) Ra[e] = out[e];
#pragma unroll
        for (int e = 0; e < 3; ++e) ta[e] = out[9 + e];
    }
    if (tid == 0) wk.fail[k] = failed ? 1 : 0;
    // each point's step dp = Hpp_k^-1 (-gp - sum_c B_pc^T dc_c), its try X + dp * valid
    const float* Hi = wk.Hinv + (size_t)k * 9 * P;
    float* Xa = wk.X_a + (size_t)k * P * 3;
    for (int p = tid; p < P; p += CHOL_THREADS) {
        const unsigned m = wk.mask[p];
        float bt[3] = {0.0f, 0.0f, 0.0f};
        for (int c = 0; c < C; ++c) {
            if (!(m & (1u << c))) continue;
            const float* Bc = wk.B + (size_t)c * 18 * P + p;
            const float* dc = v + 6 * c;
#pragma unroll
            for (int kk = 0; kk < 3; ++kk) {
                float s = Bc[(size_t)kk * P] * dc[0];
#pragma unroll
                for (int i = 1; i < 6; ++i) s += Bc[(size_t)(3 * i + kk) * P] * dc[i];
                bt[kk] += s;
            }
        }
        float rr[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) rr[j] = -wk.gp[(size_t)j * P + p] - bt[j];
        const float ptv = pb.pt_valid[p] ? 1.0f : 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float dp = dot3(Hi[(size_t)(3 * j) * P + p], rr[0], Hi[(size_t)(3 * j + 1) * P + p],
                                  rr[1], Hi[(size_t)(3 * j + 2) * P + p], rr[2]);
            Xa[3 * p + j] = o.X[3 * p + j] + dp * ptv;
        }
    }
}

// ---- host side

static size_t align4(size_t n) { return (n + 3) & ~(size_t)3; }

#define NPARTS 19

// The workspace's floats (4-byte words) for C cameras and P points; with
// `base`, each part's pointer into `w`; with `offs`, each part's offset (in
// floats) in Work's order.
static size_t layout(int C, int P, float* base, Work* w, long long* offs = nullptr) {
    size_t off = 0;
    int part = 0;
    auto take = [&](size_t count) {
        if (offs) offs[part] = (long long)off;
        ++part;
        float* p = base ? base + off : nullptr;
        off += align4(count);
        return p;
    };
    float* inv = take((size_t)C * P);
    float* mask = take(P);
    float* Hcc = take((size_t)C * 21);
    float* gc = take((size_t)C * 6);
    float* cost_lin = take(C);
    float* B = take((size_t)C * 18 * P);
    float* gp = take((size_t)3 * P);
    float* Hinv = take((size_t)27 * P);
    float* S = take((size_t)3 * C * C * 36);
    float* rhs = take((size_t)3 * C * 6);
    float* R_a = take((size_t)3 * C * 9);
    float* t_a = take((size_t)3 * C * 3);
    float* X_a = take((size_t)9 * P);
    float* cost_try = take((size_t)3 * C);
    float* fail = take(3);
    float* lam = take(1);
    float* ticket = take(1);
    float* Hpp = take((size_t)6 * P);
    float* dc = take((size_t)18 * C);
    if (w) {
        *w = Work{reinterpret_cast<int*>(inv), reinterpret_cast<unsigned*>(mask), Hcc, gc, cost_lin, B,
                  gp, Hinv, S, rhs, R_a, t_a, X_a, cost_try, reinterpret_cast<int*>(fail), lam,
                  reinterpret_cast<unsigned*>(ticket), Hpp, dc};
    }
    if (offs) offs[NPARTS] = (long long)off;
    return off;
}

// The offsets (in floats) of the workspace's parts in Work's order, then its
// size: NPARTS + 1 values into `out` (chip_smoke.py reads the parts).
// Returns NPARTS.
extern "C" int grid_ba_work_layout(int C, int P, long long* out) {
    layout(C, P, nullptr, nullptr, out);
    return NPARTS;
}

extern "C" long long grid_ba_work_bytes(int C, int P) {
    return 4 * (long long)layout(C, P, nullptr, nullptr);
}

static size_t chol_smem(int C) {
    const int np = (6 * C + NB - 1) / NB * NB;
    return ((size_t)np * (np + 1) + np) * sizeof(float);
}

// One solve: setup, `iters` x (LIN, Schur, Cholesky, TRIES), FINAL, on the
// stream.  `work` holds grid_ba_work_bytes(C, P) bytes.  Returns a
// cudaError_t (the first launch's error stops the rest).
extern "C" int grid_ba_launch(float fx, float fy, float cx, float cy, float bf, const float* R0,
                              const float* t0, const float* X0, const uint8_t* cam_fixed,
                              const uint8_t* cam_valid, const uint8_t* pt_valid, const int* pt_loc,
                              const float* uv, const float* ur, const float* is2,
                              const uint8_t* edge_valid, int C, int N, int P, int iters,
                              int robust, float lam0, float l0, float l1, float l2, void* work,
                              float* R, float* t, float* X, uint8_t* inlier, float* cost,
                              cudaStream_t stream) {
    if (C < 1 || C > MAX_C || N < 1 || P < 1 || iters < 0) return (int)cudaErrorInvalidValue;
    const Cam cm = {fx, fy, cx, cy, bf};
    Prob pb = {R0, t0, X0, cam_fixed, cam_valid, pt_valid, pt_loc, uv, ur, is2, edge_valid,
               C, N, P, robust, {l0, l1, l2}};
    Work wk;
    layout(C, P, static_cast<float*>(work), &wk);
    const Out o = {R, t, X, inlier, cost};
    const int cap = N < P ? N : P;
    const size_t schur_smem = (size_t)cap * LIST_BYTES, csmem = chol_smem(C);
    if (schur_smem > DYN_SMEM || csmem > DYN_SMEM) return (int)cudaErrorInvalidValue;
    // once a process, outside any stream capture's work: the most either kernel may take
    static bool attrs_set = false;
    cudaError_t e;
    if (!attrs_set) {
        e = cudaFuncSetAttribute(gba_schur, cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_SMEM);
        if (e != cudaSuccess) return (int)e;
        e = cudaFuncSetAttribute(gba_chol, cudaFuncAttributeMaxDynamicSharedMemorySize, DYN_SMEM);
        if (e != cudaSuccess) return (int)e;
        attrs_set = true;
    }
    gba_grid<<<C + 1, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, SETUP, lam0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    for (int it = 0; it < iters; ++it) {
        gba_grid<<<C + (P + GRID_THREADS - 1) / GRID_THREADS, GRID_THREADS, 0, stream>>>(
            cm, pb, wk, o, LIN, lam0);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        gba_schur<<<dim3(C, 3), SCHUR_THREADS, schur_smem, stream>>>(pb, wk, cap);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        gba_chol<<<3, CHOL_THREADS, csmem, stream>>>(pb, wk, o);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        gba_grid<<<3 * C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, TRIES, lam0);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    gba_grid<<<C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, FINAL, lam0);
    return (int)cudaGetLastError();
}
