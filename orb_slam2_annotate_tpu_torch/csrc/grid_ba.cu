// Kernel 12: local BA's grid LM (ba_core.bundle_adjust_grid), linearization
// to Cholesky, in 2 + 5 x iters launches of four kernels on one stream.
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
// each iteration is five dependent launches, most of them short of work
// (tools/k12_stages.py splits an iteration), and the Cholesky is a chain of
// 192 square roots and 384 divisions, each behind the terms before it.  No
// tensor cores: the blocks are 6x6, 6x3 and 3x3, and the 192 x 192
// factorization is 1.2 MFLOP.
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
//   gba_schur ((C, 3, ceil(C / 8)) CTAs): CTA (c, k, g) of a free camera c
//       compacts the points camera c sees (ascending) and stages BH = B_pc
//       Hpp_k^-1 in shared memory; warp w takes d = 8 g + w (free, <= c):
//       S_cd = -sum_p BH B_pd^T over the points d sees too (a lane every 32nd
//       point, each lane stepping to its own next point that d sees, whose
//       B_pd is loaded two points ahead, then an xor butterfly); the diagonal
//       warp adds the damped Hcc and forms the right-hand side -gc + sum_p BH
//       gp.  So no CTA takes more than 8 of the (c, d) pairs, where the first
//       design's CTA (c, k) took all c + 1 over 8 warps.
//   gba_chol (3 CTAs of 512 threads): CTA k assembles the reduced system of
//       the free cameras' rows (the right-hand side as its last row) in
//       shared memory and factors it right-looking by 32-column panels, the
//       forward solve inside: warp 0 factors each diagonal block, a lane a
//       row, no barrier a column (the next pivot shuffled first); of the
//       worker warps (those off warp 0's scheduler) half solve the rows below
//       four columns behind while the other half apply the previous panel's
//       terms to the columns past the block being factored; then all apply
//       the panel's terms to the next diagonal block (2 x 2 register tiles),
//       so warp 0 can factor it, and to the strip below it (4 x 4 tiles).
//       Where that forward solve is not finite, the full system (cameras not
//       free held by identity rows, padded to a multiple of 16) instead.  Then
//       L^T x = y over all 6C rows (rounded up to 16) by 16-row blocks: warp
//       0 the chain, helper threads a row each taking the terms of the blocks
//       solved two and more above; the step (NaN where a pivot is not > 0, 0
//       on the cameras not free) to the workspace.  204,816 B of shared
//       memory at any C.
//   gba_step ((ceil(P / 256) + 1, 3) CTAs): each ladder value's try: a
//       thread a point's step dp = Hpp_k^-1 (-gp - sum_c B_pc^T dc_c) and X +
//       dp, the last CTA the cameras' retraction.
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
// the tolerances are in chip_smoke.py.  The Cholesky's and the Schur
// blocks' chains are the first design's (16-column blocks), regrouped:
// every output and the workspace's S, rhs and dc keep that design's bits
// (tools/k12_stages.py --against; tests/test_torch_grid_ba_order.py walks
// both schedules).  No float atomics, no allocation, no host read: the
// wrapper allocates one workspace a call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CHI2_MONO 5.991f
#define CHI2_STEREO 7.815f
#define FULL 0xffffffffu
#define MAX_C 32
#define NB 16                // the system's padding and the back solve's blocks (rows)
#define PW 32                // the factorization's panels (columns)
#define GRID_THREADS 256     // a camera CTA of gba_grid
#define SCHUR_THREADS 256
#define SCHUR_DG (SCHUR_THREADS / 32)   // gba_schur: cameras d a CTA, a warp each
#define CHOL_THREADS 512
#define CHOL_WORKERS (CHOL_THREADS - CHOL_THREADS / 4)   // the warps off warp 0's scheduler
#define CHOL_MAX_ROWS (6 * MAX_C)
#define STEP_THREADS 256
#define SPIN_LIMIT_NS 2000000000ull
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

// the reduced system's rows: 6C, padded with identity rows to a multiple of NB
__host__ __device__ __forceinline__ int chol_rows(int C) { return (6 * C + NB - 1) / NB * NB; }

// gba_chol's factor in shared memory: M + 1 rows of M + 1 floats, to a multiple of 4
__host__ __device__ __forceinline__ int chol_a_floats(int M) { return ((M + 1) * (M + 1) + 3) & ~3; }

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

// ---- gba_schur: the Schur blocks S_cd of camera c's row for ladder value k,
// for the d of one group

__global__ void __launch_bounds__(SCHUR_THREADS) gba_schur(Prob pb, Work wk, int cap) {
    constexpr int NW = SCHUR_THREADS / 32;
    const int C = pb.C, P = pb.P, c = blockIdx.x, k = blockIdx.y, d0 = blockIdx.z * SCHUR_DG;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (!cam_free(pb, c) || d0 > c) return;
    bool any = false;
    for (int d = d0; d <= min(c, d0 + SCHUR_DG - 1); ++d) any |= cam_free(pb, d);
    if (!any) return;
    extern __shared__ __align__(16) unsigned char sm[];
    int* list = reinterpret_cast<int*>(sm);                 // [cap] the points c sees, ascending
    unsigned* msk = reinterpret_cast<unsigned*>(list + cap);  // [cap] their camera masks
    float* BH = reinterpret_cast<float*>(msk + cap);         // [18][cap] B_pc Hpp_k^-1
    __shared__ int wcnt[NW];

    // the points with bit c, in order: warp w ballots points [w * per, (w + 1) * per),
    // LB masks a lane loaded at once
    constexpr int LB = 8;
    const int per = (P + NW - 1) / NW, s0 = min(P, warp * per), s1 = min(P, s0 + per);
    const unsigned bit_c = 1u << c;
    int cnt = 0;
    for (int sb = s0; sb < s1; sb += 32 * LB) {
        unsigned m[LB];
#pragma unroll
        for (int u = 0; u < LB; ++u) {
            const int s = sb + 32 * u + lane;
            m[u] = s < s1 ? wk.mask[s] : 0u;
        }
#pragma unroll
        for (int u = 0; u < LB; ++u) cnt += __popc(__ballot_sync(FULL, (m[u] & bit_c) != 0u));
    }
    if (lane == 0) wcnt[warp] = cnt;
    __syncthreads();
    int base = 0, total = 0;
    for (int w = 0; w < NW; ++w) {
        base += w < warp ? wcnt[w] : 0;
        total += wcnt[w];
    }
    for (int sb = s0; sb < s1; sb += 32 * LB) {
        unsigned m[LB];
#pragma unroll
        for (int u = 0; u < LB; ++u) {
            const int s = sb + 32 * u + lane;
            m[u] = s < s1 ? wk.mask[s] : 0u;
        }
#pragma unroll
        for (int u = 0; u < LB; ++u) {
            const bool v = (m[u] & bit_c) != 0u;
            const unsigned bal = __ballot_sync(FULL, v);
            if (v) {
                const int idx = base + __popc(bal & ((1u << lane) - 1u));
                list[idx] = sb + 32 * u + lane;
                msk[idx] = m[u];
            }
            base += __popc(bal);
        }
    }
    __syncthreads();
    const float* Bc = wk.B + (size_t)c * 18 * P;
    const float* Hi = wk.Hinv + (size_t)k * 9 * P;
#pragma unroll 2
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

    // warp w: d = d0 + w; each entry of S_cd (and of the rhs) is 32 lane chains (lane
    // l: the listed points l, l + 32, .. that d sees too, in order; each lane skips to
    // its own next such point, so a step of the warp is a term in every lane with one
    // left), the B_pd (and gp) of the lane's next two points loaded ahead, then a
    // butterfly
    const int d = d0 + warp;
    if (d > c || !cam_free(pb, d)) return;
    const bool diag = d == c;
    const unsigned bit_d = 1u << d;
    const float* Bd = wk.B + (size_t)d * 18 * P;
    float acc[36], racc[6];
#pragma unroll
    for (int e = 0; e < 36; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) racc[i] = 0.0f;
    // this lane's next listed point that d sees, from idx on (total: none)
    auto seen_from = [&](int i) {
        while (i < total && !(msk[i] & bit_d)) i += 32;
        return i < total ? i : total;
    };
    // B_pd (and gp) of listed point i, 0 past the list
    auto fetch = [&](int i, float (&b)[18], float (&gg)[3]) {
        const int p = i < total ? list[i] : 0;
#pragma unroll
        for (int q = 0; q < 18; ++q) b[q] = i < total ? __ldg(Bd + (size_t)q * P + p) : 0.0f;
#pragma unroll
        for (int q = 0; q < 3; ++q) gg[q] = diag && i < total ? wk.gp[(size_t)q * P + p] : 0.0f;
    };
    // listed point i's terms
    auto terms = [&](int i, const float (&bd)[18], const float (&g)[3]) {
        float bh[18];
#pragma unroll
        for (int q = 0; q < 18; ++q) bh[q] = BH[q * cap + i];
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
            for (int l = 0; l < 6; ++l)
                acc[6 * r + l] += (bh[3 * r] * bd[3 * l] + bh[3 * r + 1] * bd[3 * l + 1]) +
                                  bh[3 * r + 2] * bd[3 * l + 2];
        if (diag) {
#pragma unroll
            for (int r = 0; r < 6; ++r)
                racc[r] += (bh[3 * r] * g[0] + bh[3 * r + 1] * g[1]) + bh[3 * r + 2] * g[2];
        }
    };
    // two points ahead in flight, in three buffers taking turns (no copy waits for a load)
    float b0[18], g0[3], b1[18], g1[3], b2[18], g2[3];
    int ia = seen_from(lane), ib = seen_from(ia + 32);
    fetch(ia, b0, g0);
    fetch(ib, b1, g1);
    while (ia < total) {
        const int ic = seen_from(ib + 32);
        fetch(ic, b2, g2);
        terms(ia, b0, g0);
        if (ib >= total) break;
        const int id = seen_from(ic + 32);
        fetch(id, b0, g0);
        terms(ib, b1, g1);
        if (ic >= total) break;
        const int ie = seen_from(id + 32);
        fetch(ie, b1, g1);
        terms(ic, b2, g2);
        ia = id;
        ib = ie;
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
        const float lk = wk.lam[0] * pb.ladder[k];
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

// ---- gba_chol: ladder value k's reduced system factored and solved

// a / b correctly rounded; a zero dividend would take IEEE division's slow path (~4 x the
// fast one on this card), and for a finite nonzero b the product a * b is the same signed
// zero, so it takes that instead
__device__ __forceinline__ float div_rn(float a, float b) {
    if (a == 0.0f && b != 0.0f && fabsf(b) <= 3.402823466e38f) return a * b;
    return a / b;
}

// a spin that outlasts SPIN_LIMIT_NS traps (a launch error) instead of holding the card
__device__ __forceinline__ void spin_until(const volatile int* flag, int value) {
    if (*flag >= value) return;
    unsigned long long t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    while (*flag < value) {
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        if (t - t0 > SPIN_LIMIT_NS) __trap();
    }
}

// the workers' barrier: the warps off warp 0's scheduler (warps 4k share it)
__device__ __forceinline__ void workers_sync() {
    asm volatile("bar.sync 1, %0;" ::"r"(CHOL_WORKERS));
}

// the panel's terms on one T x T tile of the trailing matrix: rows i0 .. i0 + T - 1
// (their entries below the diagonal, row M the right-hand side), columns q0 ..
// q0 + T - 1; entry (i, q) -= L_i,m L_q,m for the panel's columns m ascending
template <int T>
__device__ __forceinline__ void tile_terms(float* A, const float* Pt, int lda, int pts, int M, int w,
                                           int i0, int q0) {
    float a[T][T];
#pragma unroll
    for (int r = 0; r < T; ++r)
#pragma unroll
        for (int s = 0; s < T; ++s)
            a[r][s] = i0 + r <= M && q0 + s <= i0 + r ? A[(i0 + r) * lda + q0 + s] : 0.0f;
#pragma unroll 4
    for (int m = 0; m < w; ++m) {
        float vi[T], vq[T];
        if constexpr (T == 4) {
            const float4 li = *reinterpret_cast<const float4*>(Pt + m * pts + i0);
            const float4 lq = *reinterpret_cast<const float4*>(Pt + m * pts + q0);
            vi[0] = li.x, vi[1] = li.y, vi[2] = li.z, vi[3] = li.w;
            vq[0] = lq.x, vq[1] = lq.y, vq[2] = lq.z, vq[3] = lq.w;
        } else {
            static_assert(T == 2, "tiles of 2 or 4");
            const float2 li = *reinterpret_cast<const float2*>(Pt + m * pts + i0);
            const float2 lq = *reinterpret_cast<const float2*>(Pt + m * pts + q0);
            vi[0] = li.x, vi[1] = li.y;
            vq[0] = lq.x, vq[1] = lq.y;
        }
#pragma unroll
        for (int r = 0; r < T; ++r)
#pragma unroll
            for (int s = 0; s < T; ++s) a[r][s] -= vi[r] * vq[s];
    }
#pragma unroll
    for (int r = 0; r < T; ++r)
#pragma unroll
        for (int s = 0; s < T; ++s)
            if (i0 + r <= M && q0 + s <= i0 + r) A[(i0 + r) * lda + q0 + s] = a[r][s];
}

// tile t (side T) of the trailing matrix below panel rows t0: tile rows I = 0 .. nQ - 1
// hold tiles Q <= I, tile row nQ (row M) tiles Q < nQ, by rows: (t0 + T I, t0 + T Q)
template <int T>
__device__ __forceinline__ void tile_of(int t, int nQ, int t0, int& i0, int& q0) {
    const int tri = nQ * (nQ + 1) / 2;
    int I, Q;
    if (t >= tri) {
        I = nQ;
        Q = t - tri;
    } else {
        I = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
        while (I * (I + 1) / 2 > t) --I;
        while ((I + 1) * (I + 2) / 2 <= t) ++I;
        Q = t - I * (I + 1) / 2;
    }
    i0 = t0 + T * I;
    q0 = t0 + T * Q;
}

// The reduced system factored right-looking by 32-column panels with the forward solve
// as the factor's last row, then L^T x = y by 16-row blocks, every entry's terms in the
// first design's order (that design assembled the free cameras' S_cd lower triangles,
// identity rows for the other cameras and the padding to Mf = a multiple of 16, the
// right-hand side as row Mf; its terms ascending in k; its back solve by blocks from
// the last, ascending inside a block, descending inside the row's own), each product
// rounded before its subtraction, so every bit is that design's.
//
// The compact system: only the free cameras' rows.  Each term the first design takes
// from an identity row or column is L_ik L_jk with one factor exactly +0 while the
// factor and the forward solve stay finite (an identity row's entries left of its
// diagonal start at +0 and take +0 terms; +0 - (+/-0) is +0), and x - (+0) is x for
// every x, so leaving those terms out keeps every bit: a pivot fails in the compact
// system exactly where it fails in the full one (the step all NaN either way), and
// where the compact forward solve is finite the two factors and y agree on the free
// rows while the full one's identity rows are exactly I and y 0 there.  Where y is not
// finite (an identity row's 0 x inf or NaN term would spread it), the full system is
// factored instead.  The back solve runs over all Mf rows either way, reading an
// identity row's coefficients (1 on the diagonal, +0 elsewhere, y = +0) through the
// row map, so its arithmetic, NaN and infinite steps included, is the first design's.
//
// Panel p's terms on the trailing matrix (rows and columns past the panel) are split by
// what needs them: the next diagonal block (panel p + 1's rows and columns: warp 0
// factors it next), the strip below it (panel p + 1's columns: the rows below need them
// next) and the far part (every later column, needed a panel later).  Per panel p:
//   warp 0: wait until block p is up to date (dready), factor it;
//   workers, row warps: the rows below block p, four columns behind warp 0;
//   workers, far warps at the same time: panel p - 1's far part (the panel's columns
//       kept by the row warps in the other half of Pt);
//   then all workers: panel p's terms on block p + 1 (then dready), on the strip.
__global__ void __launch_bounds__(CHOL_THREADS) gba_chol(Prob pb, Work wk) {
    const int C = pb.C, k = blockIdx.x, n = 6 * C, Mf = chol_rows(C);
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    extern __shared__ __align__(16) float A[];              // [M + 1][M + 1] lower factor, row M: y
    __shared__ uint8_t fr[MAX_C];
    __shared__ short frow[CHOL_MAX_ROWS];                   // the system's row r: the step's row (-1: identity)
    __shared__ short cmap[CHOL_MAX_ROWS];                   // the step's row i: the system's row (-1: identity)
    __shared__ int s_fail, s_wide, s_nfree;
    __shared__ volatile int dcol, dready, solved;           // published columns, ready panel, solved blocks
    __shared__ int hready[CHOL_MAX_ROWS / NB];              // rows of a block with the helpers' terms
    constexpr int NWC = CHOL_THREADS / 32, AU = CHOL_MAX_ROWS / 32;
    if (tid < C) fr[tid] = cam_free(pb, tid) ? 1 : 0;
    if (tid == 0) s_wide = 0;
    __syncthreads();
    if (tid == 0) {
        int f = 0;
        for (int c = 0; c < C; ++c) f += fr[c];
        s_nfree = f;
    }
    const float* S = wk.S + (size_t)k * C * C * 36;
    int M = 0, lda = 1;
    // the compact system, then the full one where its forward solve is not finite
    for (int wide = 0; wide < 2; ++wide) {
        __syncthreads();
        if (wide && !s_wide) break;
        M = wide ? Mf : (6 * s_nfree + NB - 1) / NB * NB;
        lda = M + 1;
        const int pts = M + 4;
        float* Pt = A + chol_a_floats(M);                   // [2][PW][pts] a panel's rows below, by column
        float* Dt = Pt + 2 * PW * pts;                      // [PW][PW] the diagonal block's factor, by column
        if (tid < CHOL_MAX_ROWS) {
            // the step's row tid: its camera's rank among the free ones
            const int c = tid / 6;
            int rank = 0;
            for (int d = 0; d < c && d < C; ++d) rank += fr[d];
            const bool free_row = tid < n && fr[c];
            if (wide) {
                frow[tid] = tid < Mf && free_row ? tid : -1;
                cmap[tid] = tid < Mf ? tid : -1;
            } else {
                cmap[tid] = free_row ? 6 * rank + tid % 6 : -1;
                if (free_row) frow[6 * rank + tid % 6] = tid;
                if (tid >= 6 * s_nfree) frow[tid] = -1;
            }
        }
        if (tid < CHOL_MAX_ROWS / NB) hready[tid] = 0;
        if (tid == 0) {
            s_fail = 0;
            dcol = 0;
            dready = 0;
            solved = 0;
        }
        for (int i = tid; i < 2 * PW * pts; i += CHOL_THREADS) Pt[i] = 0.0f;
        __syncthreads();

        // assemble: row r holds the step's row frow[r] (S_cd's entries of the free columns,
        // c >= d), or an identity row; row M the rhs.  Each lane's columns' camera and
        // offset taken once, a row's loads in flight together
        int dof[AU];
        bool fcol[AU];
#pragma unroll
        for (int u = 0; u < AU; ++u) {
            const int j = lane + 32 * u, jf = j < M ? frow[j] : -1;
            fcol[u] = jf >= 0;
            dof[u] = jf >= 0 ? (jf / 6) * 36 + jf % 6 : 0;
        }
        for (int r = wid; r <= M; r += NWC) {
            float v[AU];
            if (r < M) {
                const int rf = frow[r];
                const int base = rf >= 0 ? ((rf / 6) * C) * 36 + (rf % 6) * 6 : 0;
#pragma unroll
                for (int u = 0; u < AU; ++u) {
                    const int j = lane + 32 * u;
                    v[u] = rf >= 0 && fcol[u] && j <= r ? S[(size_t)base + dof[u]] : (j == r ? 1.0f : 0.0f);
                }
            } else {
#pragma unroll
                for (int u = 0; u < AU; ++u) {
                    const int j = lane + 32 * u, jf = j < M ? frow[j] : -1;
                    v[u] = jf >= 0 ? wk.rhs[(size_t)(k * C + jf / 6) * 6 + jf % 6] : 0.0f;
                }
            }
#pragma unroll
            for (int u = 0; u < AU; ++u) {
                const int j = lane + 32 * u;
                if (j < M && (j <= r || r == M)) A[r * lda + j] = v[u];
            }
        }
        __syncthreads();

        const int npan = (M + PW - 1) / PW;
        if (wid == 0) {
            // the diagonal blocks: lane x holds row p0 + x; column jj's pivot is shuffled
            // to every lane, each takes its square root, the rows below divide and publish
            // column jj (Dt, every four columns dcol), then entry (x, c), jj < c <= x,
            // takes its term L_x,jj L_c,jj; identity past the panel's width w
            bool bad = false;
            for (int p = 0; p < npan; ++p) {
                const int p0 = p * PW, w = min(PW, M - p0);
                spin_until(&dready, p);
                __threadfence_block();
                float a[PW];
#pragma unroll
                for (int c = 0; c < PW; ++c)
                    a[c] = lane < w && c < w ? (c <= lane ? A[(p0 + lane) * lda + p0 + c] : 0.0f)
                                             : (c == lane ? 1.0f : 0.0f);
                float piv = __shfl_sync(FULL, a[0], 0);
#pragma unroll
                for (int jj = 0; jj < PW; ++jj) {
                    const float ljj = sqrtf(piv);
                    bad |= jj < w && !(piv > 0.0f);
                    // lanes above the diagonal take l = 0 (their scratch entries stay 0)
                    const float q = div_rn(a[jj], ljj);
                    const float l = lane == jj ? ljj : (lane > jj ? q : 0.0f);
                    a[jj] = l;
                    // the next pivot first: lane jj + 1's own term L_jj+1,jj^2 (the
                    // product its update below subtracts, so the same bits)
                    if (jj + 1 < PW) piv = __shfl_sync(FULL, a[jj + 1] - l * l, jj + 1);
                    Dt[jj * PW + lane] = l;
                    __syncwarp();
                    if ((jj & 3) == 3) {
                        __threadfence_block();
                        dcol = p0 + jj + 1;
                    }
#pragma unroll
                    for (int qq = (jj + 1) / 4; qq < PW / 4; ++qq) {
                        const float4 l4 = reinterpret_cast<const float4*>(Dt + jj * PW)[qq];
                        const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            if (4 * qq + e > jj) a[4 * qq + e] -= l * lv[e];
                    }
                }
                if (lane < w) {
#pragma unroll
                    for (int c = 0; c < PW; ++c)
                        if (c <= lane) A[(p0 + lane) * lda + p0 + c] = a[c];
                }
            }
            if (lane == 0 && bad) s_fail = 1;
        } else if ((wid & 3) != 0) {
            // the workers: row warps (the first half) and far warps
            const int wt = 32 * (wid - 1 - (wid >> 2)) + lane;
            const bool rows = wt < CHOL_WORKERS / 2;
            for (int p = 0; p < npan; ++p) {
                const int p0 = p * PW, w = min(PW, M - p0), t0 = p0 + w;
                float* Pp = Pt + (p & 1) * PW * pts;
                if (rows) {
                    // the rows below block p (row M among them), a thread a row, four
                    // columns behind warp 0: column jj's division, then its terms on the
                    // later columns
                    for (int i = t0 + wt; i <= M; i += CHOL_WORKERS / 2) {
                        float a[PW];
#pragma unroll
                        for (int c = 0; c < PW; ++c) a[c] = c < w ? A[i * lda + p0 + c] : 0.0f;
#pragma unroll
                        for (int jj = 0; jj < PW; ++jj) {
                            if ((jj & 3) == 0) {
                                spin_until(&dcol, p0 + jj + 4);
                                __threadfence_block();
                            }
                            const float l = div_rn(a[jj], Dt[jj * PW + jj]);
                            a[jj] = l;
#pragma unroll
                            for (int qq = (jj + 1) / 4; qq < PW / 4; ++qq) {
                                const float4 l4 = reinterpret_cast<const float4*>(Dt + jj * PW)[qq];
                                const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
                                for (int e = 0; e < 4; ++e)
                                    if (4 * qq + e > jj) a[4 * qq + e] -= l * lv[e];
                            }
                        }
#pragma unroll
                        for (int c = 0; c < PW; ++c)
                            if (c < w) {
                                A[i * lda + p0 + c] = a[c];
                                Pp[c * pts + i] = a[c];
                            }
                    }
                } else if (p > 0) {
                    // panel p - 1's terms on its far part: the columns past block p
                    const int q0p = p0 + PW;
                    const int nF = max(0, (M - q0p) / 4);
                    const float* Pq = Pt + ((p - 1) & 1) * PW * pts;
                    const int TF = nF * (nF + 1) / 2 + nF;
                    int i0, q0;
                    for (int t = wt - CHOL_WORKERS / 2; t < TF; t += CHOL_WORKERS / 2) {
                        tile_of<4>(t, nF, q0p, i0, q0);
                        tile_terms<4>(A, Pq, lda, pts, M, PW, i0, q0);
                    }
                }
                workers_sync();
                if (t0 >= M) break;
                // panel p's terms on block p + 1 (2 x 2 tiles: more threads on the
                // critical path), then on the strip below it (panel p + 1's columns)
                const int wn = min(PW, M - t0), dB = wn / 4, nQ = (M - t0) / 4;
                const int TD2 = (wn / 2) * (wn / 2 + 1) / 2, TS = (nQ - dB + 1) * dB;
                int i0, q0;
                for (int t = wt; t < TD2; t += CHOL_WORKERS) {
                    tile_of<2>(t, wn / 2, t0, i0, q0);
                    tile_terms<2>(A, Pp, lda, pts, M, w, i0, q0);
                }
                workers_sync();
                if (wt == 0) {
                    __threadfence_block();
                    dready = p + 1;
                }
                for (int t = wt; t < TS; t += CHOL_WORKERS)
                    tile_terms<4>(A, Pp, lda, pts, M, w, t0 + 4 * (dB + t / dB), t0 + 4 * (t % dB));
                workers_sync();
            }
        }
        __syncthreads();
        // the compact forward solve not finite (and no pivot failed): the full system
        if (!wide && !s_fail)
            for (int j = tid; j < M; j += CHOL_THREADS)
                if (!isfinite(A[M * lda + j])) s_wide = 1;
    }

    // L^T x = y over the Mf rows by 16-row blocks from the last, row i's coefficients and
    // y through cmap (an identity row where it has none): warp 0 carries the chain (block
    // b + 1's terms on block b, then block b's own 16 steps; the next block's coefficients
    // loaded ahead); each helper thread owns a row of the blocks below and takes each
    // later block's terms as it is solved (blocks b + 2 and up), then hands its sum over
    float* xs = A + chol_a_floats(CHOL_MAX_ROWS);            // [Mf] x
    float* hv = xs + Mf;                                     // [Mf] the back solve's helper sums
    auto L = [&](int r, int i) {                             // L_ri, r >= i (loads without branches)
        const int rc = cmap[r], ic = cmap[i];
        const float v = A[max(rc, 0) * lda + max(ic, 0)];
        return rc >= 0 && ic >= 0 ? v : (r == i ? 1.0f : 0.0f);
    };
    auto y_of = [&](int i) {
        const int ic = cmap[i];
        const float v = A[M * lda + max(ic, 0)];
        return ic >= 0 ? v : 0.0f;
    };
    const int nbk = Mf / NB;
    if (wid == 0) {
        const int lr = lane < NB ? lane : 0;
        float cf[NB], dd[NB], tm[NB];
        // block b's L(b0 + j, i), L(b0 + j, b0 + j) and L(b0 + 16 + j, i) for the lane's row
        // i = b0 + lr, as L() gives them, the row map read once a row
        auto coefficients = [&](int b) {
            const int b0 = b * NB, ic = cmap[b0 + lr], icz = max(ic, 0);
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                const int rc = cmap[b0 + j], rd = b + 1 < nbk ? cmap[b0 + NB + j] : -1;
                const int rcz = max(rc, 0), rdz = max(rd, 0);
                const float vc = A[rcz * lda + icz], vd = A[rcz * lda + rcz], vt = A[rdz * lda + icz];
                cf[j] = rc >= 0 && ic >= 0 ? vc : (j == lr ? 1.0f : 0.0f);
                dd[j] = rc >= 0 ? vd : 1.0f;
                tm[j] = rd >= 0 && ic >= 0 ? vt : 0.0f;
            }
        };
        coefficients(nbk - 1);
        for (int b = nbk - 1; b >= 0; --b) {
            const int b0 = b * NB, i = b0 + lr;
            float acc;
            if (b + 2 < nbk) {
                spin_until(reinterpret_cast<volatile int*>(hready + b), NB);
                __threadfence_block();
                acc = hv[i];
            } else {
                acc = y_of(i);
            }
            if (b + 1 < nbk) {
#pragma unroll
                for (int m = 0; m < NB; ++m) acc -= tm[m] * xs[b0 + NB + m];
            }
#pragma unroll
            for (int j = NB - 1; j >= 0; --j) {
                const float xj = div_rn(__shfl_sync(FULL, acc, j), dd[j]);
                acc = lane == j ? xj : (lane < j ? acc - cf[j] * xj : acc);
            }
            if (lane < NB) xs[i] = acc;
            __syncwarp();
            __threadfence_block();
            solved = nbk - b;
            if (b > 0) coefficients(b - 1);
        }
    } else if ((wid & 3) != 0) {
        const int i = 32 * (wid - 1 - (wid >> 2)) + lane;
        if (i < Mf - 2 * NB) {
            const int b = i / NB;
            float acc = y_of(i);
            for (int B = nbk - 1; B >= b + 2; --B) {
                float cm[NB];
#pragma unroll
                for (int m = 0; m < NB; ++m) cm[m] = L(B * NB + m, i);
                spin_until(&solved, nbk - B);
                __threadfence_block();
#pragma unroll
                for (int m = 0; m < NB; ++m) acc -= cm[m] * xs[B * NB + m];
            }
            hv[i] = acc;
            __threadfence_block();
            atomicAdd(hready + b, 1);
        }
    }
    __syncthreads();

    // the step: NaN where the factorization failed, 0 on the cameras not free
    const bool failed = s_fail != 0;
    for (int i = tid; i < n; i += CHOL_THREADS)
        wk.dc[(size_t)k * n + i] = fr[i / 6] ? (failed ? __int_as_float(0x7fc00000) : xs[i]) : 0.0f;
    if (tid == 0) wk.fail[k] = failed ? 1 : 0;
}

// ---- gba_step: each ladder value's try: the cameras retracted by their steps, each
// point's step dp = Hpp_k^-1 (-gp - sum_c B_pc^T dc_c) and its try X + dp * valid

__global__ void __launch_bounds__(STEP_THREADS) gba_step(Prob pb, Work wk, Out o) {
    const int C = pb.C, P = pb.P, k = blockIdx.y, n = 6 * C, tid = threadIdx.x;
    __shared__ float dcs[6 * MAX_C];
    for (int i = tid; i < n; i += STEP_THREADS) dcs[i] = wk.dc[(size_t)k * n + i];
    __syncthreads();
    if (blockIdx.x == gridDim.x - 1) {
        if (tid < C) {
            float Pc[12], out[12];
#pragma unroll
            for (int e = 0; e < 9; ++e) Pc[e] = o.R[9 * tid + e];
#pragma unroll
            for (int e = 0; e < 3; ++e) Pc[9 + e] = o.t[3 * tid + e];
            se3_retract(dcs + 6 * tid, Pc, out);
            float* Ra = wk.R_a + (size_t)(k * C + tid) * 9;
            float* ta = wk.t_a + (size_t)(k * C + tid) * 3;
#pragma unroll
            for (int e = 0; e < 9; ++e) Ra[e] = out[e];
#pragma unroll
            for (int e = 0; e < 3; ++e) ta[e] = out[9 + e];
        }
        return;
    }
    const int p = blockIdx.x * STEP_THREADS + tid;
    if (p >= P) return;
    const float* Hi = wk.Hinv + (size_t)k * 9 * P;
    float* Xa = wk.X_a + (size_t)k * P * 3;
    const unsigned m = wk.mask[p];
    float bt[3] = {0.0f, 0.0f, 0.0f};
    for (int c = 0; c < C; ++c) {
        if (!(m & (1u << c))) continue;
        const float* Bc = wk.B + (size_t)c * 18 * P + p;
        const float* dc = dcs + 6 * c;
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

// gba_chol's dynamic shared memory: the factor, two panels by column and the diagonal
// block's factor at the full size, x and the helpers' sums inside the panels (204,816 bytes)
static size_t chol_smem() {
    const int M = CHOL_MAX_ROWS;
    return ((size_t)chol_a_floats(M) + 2 * PW * (M + 4) + PW * PW + 2 * M) * sizeof(float);
}

// One solve: setup, `iters` x (LIN, Schur, Cholesky, step, TRIES), FINAL, on the
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
    const size_t schur_smem = (size_t)cap * LIST_BYTES, csmem = chol_smem();
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
        gba_schur<<<dim3(C, 3, (C + SCHUR_DG - 1) / SCHUR_DG), SCHUR_THREADS, schur_smem, stream>>>(
            pb, wk, cap);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        gba_chol<<<3, CHOL_THREADS, csmem, stream>>>(pb, wk);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        gba_step<<<dim3((P + STEP_THREADS - 1) / STEP_THREADS + 1, 3), STEP_THREADS, 0, stream>>>(
            pb, wk, o);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        gba_grid<<<3 * C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, TRIES, lam0);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    gba_grid<<<C, GRID_THREADS, 0, stream>>>(cm, pb, wk, o, FINAL, lam0);
    return (int)cudaGetLastError();
}
