// Kernels 7 and 8: loop closing's Sim3 RANSAC after its draw, and its Sim3 LM.
//
// Kernel 7, sim3_ransac: replaces (JAX reference) solvers/sim3.py
// sim3_ransac after the draw (:96-99): the vmapped horn_sim3 of every
// sampled triple (:101-104), the vmapped `score` (:106-127), the argmax
// (:129) and the refinement: the weighted Horn over the best hypothesis's
// inliers, its score, and the choice between the two (:130-140).  On the
// main path H = 1024 sampled triples of N = 512 pairs (a keyframe's
// features; 10-45 of them valid on the loop cell).
//
// Bound: operations.  Scoring is ~33 operations a valid pair and direction
// and hypothesis; a 3-point Horn is ~700 at SVD-level work; the refinement
// rescores the N pairs twice and sums ~20 products a pair.  The bytes (the
// pairs, the triples and the outputs) take far less.  What the card pays
// is latency: a Horn is a chain of ~36 Jacobi rotations, each a few
// dependent IEEE divisions and square roots.
//
// Design: a CTA of 8 warps takes 32 hypotheses and one of S = ceil(N / 128)
// parts of the valid pairs.  (a) Warps 1-7 stage its part in shared memory
// (the valid pairs ranked in order by warp ballots, every S-th rank; 48 B a
// pair: x1, x2, uv1, uv2 and the two inverse sigma^2); counts are integers,
// so the split changes none.  (b) Meanwhile warp 0 fits one hypothesis a
// lane: its triple read from global memory by the sampled indices (with
// fewer than 3 valid pairs the draws come from all N), then Horn in
// registers: centroids, M, Q, JACOBI_SWEEPS cyclic Jacobi sweeps of Q (a
// pair rotates only while q_pq^2 > 2^-48 (q_pp^2 + q_qq^2)), the
// eigenvector of the largest eigenvalue (the last on ties, as eigh's
// ascending order leaves it), R, s, t; it publishes them in shared memory
// and in a [H, 13] workspace.  (c) All 8 warps score the 32 hypotheses, lane
// k hypothesis k, each warp over an eighth of the staged pairs (a pair read
// by the whole warp at once); the warps' counts meet in shared memory, the
// parts' by atomics in a per-device workspace.  (A lane a pair with a
// ballot a hypothesis would serialise the 32 tests.)  (d) The last CTA to
// finish (an atomic ticket taken after __threadfence()) reads the counts
// (resetting the workspace), picks the first best by a maximum of
// (count << 16 | H - 1 - h), and runs the weighted Horn over the best's
// inliers (its mask found over all N in the first pass; every sum a fixed
// pairwise tree over the N indices padded with zeros to a power of two:
// adjacent pairs, then adjacent pairs of those), its Jacobi on one lane; it
// rescores the refined Sim3, keeps it when it counts at least as many,
// writes the outputs and resets the ticket.
//
// Bit for bit as the plain twin (kernels/sim3.py sim3_ransac_solve_plain):
// every operation is +, -, x, / or sqrt, each correctly rounded, in the
// twin's order, built with --fmad=false; a lower clamp keeps NaN as
// torch.clamp_min does.
//
// Kernel 8, sim3_lm: replaces (JAX reference) solvers/sim3.py optimize_sim3
// (:172-259) with _sim3_project_residuals (:143), the jacfwd linearization
// through geometry/lie.py sim3_retract, jnp.linalg.solve and the chi2 inlier
// refresh.  Bound: the dependency chain of 8 iterations (the bytes and the
// ~600 operations a valid pair an iteration are well under a microsecond).
// One CTA, no host read in between: (a) the valid pairs staged once in
// shared memory, compacted in order with their indices (invalid pairs add
// exactly zero to every sum); (b) one pass a iteration at the current Sim3
// refreshes the previous iteration's chi2 inlier mask (the reference
// evaluates it at the Sim3 the next iteration linearizes at) and, over the
// refreshed inliers, accumulates the 28 upper entries of H, the 7 of g (the
// analytic left-tangent Jacobian of both edges: d(exp(xi) p)/dxi = [I,
// -hat(p), p] forward, -(1/s) R^T [I, -hat(x2), x2] inverse) and the robust
// cost; each warp sums its 36 accumulators by a transposing butterfly
// (lane i ends with accumulators 2i and 2i + 1); (c) warps 0-2 each take one
// ladder value lambda x {1, 8, 64} and solve the damped 7x7 row-parallel (a
// lane a row; positive definite, so no pivoting), then retract (sim3_exp
// with the reference's Taylor branches); (d) one pass costs the three
// candidates; (e) thread 0 takes the first improving one and updates
// lambda.  A last pass refreshes the mask at the final Sim3.  Scale is
// frozen when fix_scale.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define NWARP (NT / 32)
#define HPC 32               // kernel 7: hypotheses per CTA, a lane of warp 0 each
#define PAIRS_PER_PART 128   // kernel 7: the pairs split into ceil(N / 128) parts
#define JACOBI_SWEEPS 6      // kernels/sim3.py JACOBI_SWEEPS
#define ORTHO_TOL2 0x1p-48f  // ORTHO_TOL2
#define MAX_N 4096
#define MAX_BLOCKS (MAX_N / 32)  // 32-element blocks of a tree sum
#define STAGED_BYTES 48      // a staged pair: 3 float4
#define HYP_FLOATS 13        // s, R, t
#define STATIC_SMEM 4096     // at least either kernel's static shared memory: past 48 KB
                             // with it, the dynamic size needs the attribute
#define FULL 0xffffffffu

struct Cam { float fx, fy, cx, cy; };

// The pairs in global memory; is1 / is2 null means all ones.
struct PairsIn {
    const float *x1, *x2, *uv1, *uv2, *is1, *is2;
    const uint8_t* valid;
};

struct Pair { float a[3], b[3], u1, v1, u2, v2, i1, i2; };

__device__ __forceinline__ Pair load_pair(const PairsIn& in, int i) {
    Pair p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        p.a[c] = in.x1[3 * i + c];
        p.b[c] = in.x2[3 * i + c];
    }
    p.u1 = in.uv1[2 * i];
    p.v1 = in.uv1[2 * i + 1];
    p.u2 = in.uv2[2 * i];
    p.v2 = in.uv2[2 * i + 1];
    p.i1 = in.is1 ? in.is1[i] : 1.f;
    p.i2 = in.is2 ? in.is2[i] : 1.f;
    return p;
}

__device__ __forceinline__ Pair load_staged(const float4* st, int p) {
    const float4 q0 = st[3 * p], q1 = st[3 * p + 1], q2 = st[3 * p + 2];
    return {{q0.x, q0.y, q0.z}, {q0.w, q1.x, q1.y}, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
}

// Stage the valid pairs in order, 3 float4 each, and (if idx) their
// indices: of the valid pairs' ranks p, those with p % S == part, at
// p / S; returns how many.  The warps from first_warp on take part (with
// first_warp > 0 they meet at named barrier 1, and warp 0 is free).
// wcnt: NWARP ints of shared memory.
__device__ int stage_valid(const PairsIn& in, int N, float4* st, uint16_t* idx, int* wcnt,
                           int part = 0, int S = 1, int first_warp = 0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nthr = NT - 32 * first_warp, t = threadIdx.x - 32 * first_warp;
    const auto sync = [&] {
        if (first_warp) asm volatile("bar.sync 1, %0;" ::"r"(nthr) : "memory");
        else __syncthreads();
    };
    int base = 0;
    for (int c = 0; c < N; c += nthr) {
        const int i = c + t;
        const bool v = i < N && in.valid[i];
        const unsigned b = __ballot_sync(FULL, v);
        if (lane == 0) wcnt[warp] = __popc(b);
        sync();
        int off = base, tot = 0;
        for (int w = first_warp; w < NWARP; ++w) {
            const int cw = wcnt[w];
            off += w < warp ? cw : 0;
            tot += cw;
        }
        const int p = off + __popc(b & ((1u << lane) - 1u)) - part;
        if (v && p % S == 0) {
            const Pair q = load_pair(in, i);
            const int r = p / S;
            st[3 * r] = make_float4(q.a[0], q.a[1], q.a[2], q.b[0]);
            st[3 * r + 1] = make_float4(q.b[1], q.b[2], q.u1, q.v1);
            st[3 * r + 2] = make_float4(q.u2, q.v2, q.i1, q.i2);
            if (idx) idx[r] = (uint16_t)i;
        }
        base += tot;
        sync();
    }
    return base > part ? (base - 1 - part) / S + 1 : 0;
}

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// ---------------------------------------------------------------------------
// Kernel 7
// ---------------------------------------------------------------------------

// A Sim3 with its inverse's scale and translation, for scoring both ways.
struct Hyp { float s, R[3][3], t[3], si, ti[3]; };

__device__ __forceinline__ Hyp with_inverse(float s, const float (&R)[3][3], const float (&t)[3]) {
    Hyp h;
    h.s = s;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        h.t[i] = t[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) h.R[i][j] = R[i][j];
    }
    h.si = 1.f / s;
#pragma unroll
    for (int i = 0; i < 3; ++i) h.ti[i] = -(h.si * ((R[0][i] * t[0] + R[1][i] * t[1]) + R[2][i] * t[2]));
    return h;
}

// x1 through S into image 2 and x2 through S^-1 into image 1: both squared
// pixel errors (times inv_sigma2) below th and both depths positive
// (kernels/sim3.py sim3_score_plain).
__device__ __forceinline__ bool two_way_inlier(const Hyp& S, const Pair& p, const Cam& c, float th) {
    float y2[3], y1[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        y2[i] = S.s * ((p.a[0] * S.R[i][0] + p.a[1] * S.R[i][1]) + p.a[2] * S.R[i][2]) + S.t[i];
        y1[i] = S.si * ((p.b[0] * S.R[0][i] + p.b[1] * S.R[1][i]) + p.b[2] * S.R[2][i]) + S.ti[i];
    }
    const float z1 = clamp_lo(y1[2], 1e-6f), z2 = clamp_lo(y2[2], 1e-6f);
    const float du1 = (c.fx * y1[0] / z1 + c.cx) - p.u1;
    const float dv1 = (c.fy * y1[1] / z1 + c.cy) - p.v1;
    const float du2 = (c.fx * y2[0] / z2 + c.cx) - p.u2;
    const float dv2 = (c.fy * y2[1] / z2 + c.cy) - p.v2;
    const float e1 = (du1 * du1 + dv1 * dv1) * p.i1;
    const float e2 = (du2 * du2 + dv2 * dv2) * p.i2;
    return e1 < th && e2 < th && y1[2] > 0.f && y2[2] > 0.f;
}

// R from M = sum a b^T: Horn's Q, JACOBI_SWEEPS cyclic Jacobi sweeps, the
// quaternion of the largest eigenvalue (the last on ties), in horn_q /
// jacobi_eig4 / horn_rotation's order.
__device__ void horn_rotation(const float (&M)[3][3], float (&R)[3][3]) {
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
        if (A[i][i] >= best) {
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
    horn_rotation(M, R);
    float Ra[3][3];
#pragma unroll
    for (int kk = 0; kk < 3; ++kk)
#pragma unroll
        for (int i = 0; i < 3; ++i) Ra[kk][i] = dot3(R[i], a[kk]);
    const float num = (dot3(Ra[0], b[0]) + dot3(Ra[1], b[1])) + dot3(Ra[2], b[2]);
    const float den = clamp_lo((dot3(Ra[0], Ra[0]) + dot3(Ra[1], Ra[1])) + dot3(Ra[2], Ra[2]), 1e-12f);
    s = fix_scale ? 1.f : num / den;
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = c2[i] - s * dot3(R[i], c1);
}

// K sums over the elements 0..N-1, value(e, v) giving element e's K terms,
// each as kernels/sim3.py tree_sum: padded with +0 to P = 2^ceil(log2 N),
// then adjacent pairs added level by level.  A warp takes a 32-element block
// (the shuffles by 1, 2, ..., 16 add adjacent pairs, so lane 0 ends with
// the block's subtree); one warp a sum then adds the <= MAX_BLOCKS block
// partials the same way.  part: K x MAX_BLOCKS floats of shared memory.
template <int K, class F>
__device__ void tree_sums(int N, F value, float* part, float* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int P = 1;
    while (P < N) P <<= 1;
    const int nb = P > 32 ? P / 32 : 1, top = P < 32 ? P : 32;
    for (int blk = warp; blk < nb; blk += NWARP) {
        const int e = blk * 32 + lane;
        float v[K];
        if (e < N) {
            value(e, v);
        } else {
#pragma unroll
            for (int k = 0; k < K; ++k) v[k] = 0.f;
        }
        for (int o = 1; o < top; o <<= 1)
#pragma unroll
            for (int k = 0; k < K; ++k) v[k] += __shfl_down_sync(FULL, v[k], o);
        if (lane == 0)
#pragma unroll
            for (int k = 0; k < K; ++k) part[k * MAX_BLOCKS + blk] = v[k];
    }
    __syncthreads();
    const int q = nb > 32 ? nb / 32 : 1, top2 = nb < 32 ? nb : 32;
    for (int k = warp; k < K; k += NWARP) {
        const float* pk = part + k * MAX_BLOCKS + lane * q;
        float v = 0.f;
        if (lane < top2) v = q == 1 ? pk[0] : (q == 2 ? pk[0] + pk[1] : (pk[0] + pk[1]) + (pk[2] + pk[3]));
        for (int o = 1; o < top2; o <<= 1) v += __shfl_down_sync(FULL, v, o);
        if (lane == 0) out[k] = v;
    }
    __syncthreads();
}

struct RansacArgs {
    const long long* samples;
    PairsIn in;
    int H, N;
    Cam cam;
    float th;
    int fix_scale, min_inliers;
    float* hyp;            // [H, 13] workspace: each hypothesis's s, R, t
    int* acc;              // [>= H] workspace: the parts' counts added, 0 between calls
    int* counts;           // [H]
    long long* best;
    float *s, *R, *t;
    uint8_t *inliers, *success;
    int* n;
    unsigned* ticket;      // 0 between calls
};

__global__ void __launch_bounds__(NT) sim3_ransac_kernel(const RansacArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ Hyp s_hyp[HPC];
    __shared__ int s_cnt[HPC], s_wcnt[NWARP];
    __shared__ int s_key, s_nr, s_nv, is_last;
    __shared__ float s_sum[9], s_Rr[3][3];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int H = a.H, N = a.N;
    const PairsIn& in = a.in;

    // (a) warps 1-7 stage the valid pairs while (b) warp 0 fits a
    // hypothesis a lane
    const int h = blockIdx.x * HPC + lane, part = blockIdx.y, S = gridDim.y;
    float4* st = reinterpret_cast<float4*>(smem);
    if (warp > 0) {
        const int nv = stage_valid(in, N, st, nullptr, s_wcnt, part, S, 1);
        if (tid == 32) s_nv = nv;
    } else {
        const int hs = min(h, H - 1);                 // past H: fit a copy, write nothing
        float p1[3][3], p2[3][3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const long long raw = a.samples[(size_t)hs * 3 + k];
            const int i = (int)min(max(raw, 0ll), (long long)(N - 1));
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                p1[k][c] = in.x1[3 * i + c];
                p2[k][c] = in.x2[3 * i + c];
            }
        }
        float s, R[3][3], t[3];
        horn3(p1, p2, a.fix_scale != 0, s, R, t);
        s_hyp[lane] = with_inverse(s, R, t);
        s_cnt[lane] = 0;
        if (h < H && part == 0) {
            float* o = a.hyp + (size_t)h * HYP_FLOATS;
            o[0] = s;
#pragma unroll
            for (int k = 0; k < 9; ++k) o[1 + k] = R[k / 3][k % 3];
#pragma unroll
            for (int k = 0; k < 3; ++k) o[10 + k] = t[k];
        }
    }
    __syncthreads();

    // (c) every warp: lane k tests hypothesis k against the warp's share of
    // the staged pairs (every lane reads the same pair)
    const Hyp hk = s_hyp[lane];
    const int nv = s_nv;
    int cnt = 0;
#pragma unroll 4
    for (int p = warp; p < nv; p += NWARP) cnt += two_way_inlier(hk, load_staged(st, p), a.cam, a.th);
    if (cnt) atomicAdd(&s_cnt[lane], cnt);
    __syncthreads();
    if (warp == 0) {
        if (h < H && s_cnt[lane]) atomicAdd(&a.acc[h], s_cnt[lane]);
        __threadfence();                          // warp 0 wrote all the last CTA reads
    }

    // (d) the last CTA: the first best, its mask, the weighted Horn over it,
    // the refined Sim3's mask, the choice
    __syncthreads();
    if (tid == 0) {
        is_last = atomicAdd(a.ticket, 1u) == gridDim.x * gridDim.y - 1;
        s_key = -1;
        s_nr = 0;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    int key = -1;
    for (int i = tid; i < H; i += NT) {
        const int c = __ldcg(&a.acc[i]);
        a.acc[i] = 0;
        a.counts[i] = c;
        key = max(key, (c << 16) | (H - 1 - i));
    }
    atomicMax(&s_key, key);
    __syncthreads();
    const int hb = H - 1 - (s_key & 0xffff), n_b = s_key >> 16;
    if (tid == 0) {
        const float* o = a.hyp + (size_t)hb * HYP_FLOATS;
        float R[3][3], t[3];
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k / 3][k % 3] = __ldcg(o + 1 + k);
#pragma unroll
        for (int k = 0; k < 3; ++k) t[k] = __ldcg(o + 10 + k);
        s_hyp[0] = with_inverse(__ldcg(o), R, t);
    }
    __syncthreads();
    uint8_t* mask_b = smem;                       // the staged pairs are done with
    uint8_t* mask_r = smem + N;
    float* partials = reinterpret_cast<float*>(smem + ((2 * N + 15) & ~15));

    // the weighted Horn (kernels/sim3.py horn_sim3) over the best's mask,
    // found in its first pass
    tree_sums<7>(N, [&](int e, float (&v)[7]) {
        const bool m = in.valid[e] && two_way_inlier(s_hyp[0], load_pair(in, e), a.cam, a.th);
        mask_b[e] = m;
        const float w = m ? 1.f : 0.f;
        v[0] = w;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            v[1 + c] = in.x1[3 * e + c] * w;
            v[4 + c] = in.x2[3 * e + c] * w;
        }
    }, partials, s_sum);
    const float wsum = clamp_lo(s_sum[0], 1e-9f);
    float c1[3], c2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        c1[c] = s_sum[1 + c] / wsum;
        c2[c] = s_sum[4 + c] / wsum;
    }
    tree_sums<9>(N, [&](int e, float (&v)[9]) {
        const float w = mask_b[e] ? 1.f : 0.f;
        float ea[3], eb[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            ea[c] = in.x1[3 * e + c] - c1[c];
            eb[c] = in.x2[3 * e + c] - c2[c];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) v[3 * i + j] = (ea[i] * eb[j]) * w;
    }, partials, s_sum);
    if (tid == 0) {
        float M[3][3];
#pragma unroll
        for (int k = 0; k < 9; ++k) M[k / 3][k % 3] = s_sum[k];
        horn_rotation(M, s_Rr);
    }
    __syncthreads();
    float R[3][3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k / 3][k % 3] = s_Rr[k / 3][k % 3];
    tree_sums<2>(N, [&](int e, float (&v)[2]) {
        const float w = mask_b[e] ? 1.f : 0.f;
        float ea[3], eb[3], Ra[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            ea[c] = in.x1[3 * e + c] - c1[c];
            eb[c] = in.x2[3 * e + c] - c2[c];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) Ra[i] = dot3(R[i], ea);
        v[0] = dot3(Ra, eb) * w;
        v[1] = dot3(Ra, Ra) * w;
    }, partials, s_sum);
    if (tid == 0) {
        const float den = clamp_lo(s_sum[1], 1e-12f);
        const float s = a.fix_scale ? 1.f : s_sum[0] / den;
        float t[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) t[i] = c2[i] - s * dot3(R[i], c1);
        s_hyp[1] = with_inverse(s, R, t);
    }
    __syncthreads();
    for (int base = 0; base < N; base += NT) {
        const int e = base + tid;
        const bool m = e < N && in.valid[e] && two_way_inlier(s_hyp[1], load_pair(in, e), a.cam, a.th);
        if (e < N) mask_r[e] = m;
        const unsigned b = __ballot_sync(FULL, m);
        if (lane == 0 && b) atomicAdd(&s_nr, __popc(b));
    }
    __syncthreads();
    const bool use = s_nr >= n_b;
    const uint8_t* mask = use ? mask_r : mask_b;
    for (int e = tid; e < N; e += NT) a.inliers[e] = mask[e];
    if (tid == 0) {
        const Hyp& f = s_hyp[use ? 1 : 0];
        const int n = max(s_nr, n_b);
        *a.s = f.s;
#pragma unroll
        for (int k = 0; k < 9; ++k) a.R[k] = f.R[k / 3][k % 3];
#pragma unroll
        for (int k = 0; k < 3; ++k) a.t[k] = f.t[k];
        *a.n = n;
        *a.success = n >= a.min_inliers;
        *a.best = hb;
        *a.ticket = 0u;
    }
}

// ticket [1] and acc [>= H] hold 0 between calls; hyp [H * 13] is workspace.
extern "C" int sim3_ransac_launch(const long long* samples, const float* x1, const float* x2,
                                  const float* uv1, const float* uv2, const uint8_t* valid,
                                  const float* is1, const float* is2, int H, int N, float fx,
                                  float fy, float cx, float cy, float th, int fix_scale,
                                  int min_inliers, float* hyp, int* acc, int* counts,
                                  long long* best,
                                  float* s, float* R, float* t, uint8_t* inliers, int* n,
                                  uint8_t* success, unsigned* ticket, cudaStream_t stream) {
    if (N <= 0 || N > MAX_N || H <= 0 || H >= (1 << 15)) return (int)cudaErrorInvalidValue;
    const int parts = (N + PAIRS_PER_PART - 1) / PAIRS_PER_PART;
    const size_t staged = (size_t)PAIRS_PER_PART * STAGED_BYTES;
    const size_t refine = (size_t)((2 * N + 15) & ~15) + 9 * MAX_BLOCKS * sizeof(float);
    const size_t smem = staged > refine ? staged : refine;
    if (smem + STATIC_SMEM > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sim3_ransac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    RansacArgs a;
    a.samples = samples;
    a.in = {x1, x2, uv1, uv2, is1, is2, valid};
    a.H = H;
    a.N = N;
    a.cam = {fx, fy, cx, cy};
    a.th = th;
    a.fix_scale = fix_scale;
    a.min_inliers = min_inliers;
    a.hyp = hyp;
    a.acc = acc;
    a.counts = counts;
    a.best = best;
    a.s = s;
    a.R = R;
    a.t = t;
    a.inliers = inliers;
    a.success = success;
    a.n = n;
    a.ticket = ticket;
    sim3_ransac_kernel<<<dim3((H + HPC - 1) / HPC, parts), NT, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel 8
// ---------------------------------------------------------------------------

#define NACC 36              // H upper triangle (28), g (7), cost

struct Sim { float s, R[9], t[3]; };

struct LmState {
    Sim cur, cand[3];
    float part[NWARP][NACC];
    float red[NACC];
    float cpart[NWARP][3];
    float lam;
    int n_inl;
    int wcnt[NWARP];
};

__constant__ float c_ladder[3] = {1.0f, 8.0f, 64.0f};

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    return v;
}

// One step of the transposing butterfly: the lanes with bit HH/2 set keep
// the upper HH of v's 2 HH values, the others the lower, each adding its
// partner's copy of the half it keeps.
template <int HH>
__device__ __forceinline__ void halve(float (&v)[64], int lane) {
    const bool up = (lane & (HH / 2)) != 0;
#pragma unroll
    for (int j = 0; j < HH; ++j) {
        const float send = up ? v[j] : v[j + HH];
        const float keep = up ? v[j + HH] : v[j];
        v[j] = keep + __shfl_xor_sync(FULL, send, HH / 2);
    }
}

// The warp's sums of 64 values a lane: lane i ends with sums 2i, 2i + 1 in v[0], v[1].
__device__ __forceinline__ void transpose_sum(float (&v)[64], int lane) {
    halve<32>(v, lane);
    halve<16>(v, lane);
    halve<8>(v, lane);
    halve<4>(v, lane);
    halve<2>(v, lane);
}

// One pair's forward point y2 = S x1 and inverse point y1 = S^-1 x2, their
// pixel residuals (scaled by sqrt(inv_sigma2)), chi2 and depth test, in
// project_residuals' terms.
struct PairRes {
    float y2[3], y1[3], iz2, iz1, r[4], cf, ci;
    bool dok;
};

__device__ __forceinline__ PairRes pair_res(const Cam& c, const Sim& S, const Pair& q) {
    PairRes o;
    const float si = 1.f / S.s;
    float ti[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) ti[i] = -si * ((S.R[i] * S.t[0] + S.R[3 + i] * S.t[1]) + S.R[6 + i] * S.t[2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        o.y2[i] = S.s * ((q.a[0] * S.R[3 * i] + q.a[1] * S.R[3 * i + 1]) + q.a[2] * S.R[3 * i + 2]) + S.t[i];
        o.y1[i] = si * ((q.b[0] * S.R[i] + q.b[1] * S.R[3 + i]) + q.b[2] * S.R[6 + i]) + ti[i];
    }
    o.iz2 = __frcp_rn(fmaxf(o.y2[2], 1e-6f));
    o.iz1 = __frcp_rn(fmaxf(o.y1[2], 1e-6f));
    const float w2 = sqrtf(q.i2), w1 = sqrtf(q.i1);
    o.r[0] = ((c.fx * o.y2[0] * o.iz2 + c.cx) - q.u2) * w2;
    o.r[1] = ((c.fy * o.y2[1] * o.iz2 + c.cy) - q.v2) * w2;
    o.r[2] = ((c.fx * o.y1[0] * o.iz1 + c.cx) - q.u1) * w1;
    o.r[3] = ((c.fy * o.y1[1] * o.iz1 + c.cy) - q.v1) * w1;
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
__device__ __forceinline__ void add_row(float (&acc)[64], const float (&J)[7], float r) {
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
    // so3_exp (x = theta unless small, so one sincosf serves it and W)
    const bool small = sq < 1e-8f;
    const float sq_safe = small ? 1.f : sq;
    const float x = sqrtf(sq_safe);
    const float theta = sqrtf(sq);
    float sn_t, cs_t;
    sincosf(theta, &sn_t, &cs_t);
    const float a_ = small ? 1.f - sq / 6.f : sn_t / x;
    const float b_ = small ? 0.5f - sq / 24.f : (1.f - cs_t) / sq_safe;
    // the translation's W
    const float s = expf(sigma);
    const bool sig_small = fabsf(sigma) < 1e-5f, th_small = theta < 1e-5f;
    const float sig_safe = sig_small ? 1.f : sigma, th_safe = th_small ? 1.f : theta;
    const float C = sig_small ? 1.f + sigma / 2.f + sigma * sigma / 6.f : (s - 1.f) / sig_safe;
    const float bb = s * cs_t, aa = s * sn_t;
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

// Solve the damped 7x7 H x = g of one ladder value, a lane a row (lanes
// 7-31 hold zero rows): elimination without pivoting (H is J^T J plus a
// positive diagonal, so symmetric positive definite, and a pivot search by
// warp argmax would lengthen every step), then back substitution, by
// reciprocals and fused multiply-adds (kernel 8 is held to tolerances, not
// bits); every lane ends with x.
__device__ void solve7_rows(float (&row)[8], int lane, float (&x)[7]) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
        float pr[8];
#pragma unroll
        for (int j = k; j < 8; ++j) pr[j] = __shfl_sync(FULL, row[j], k);
        const float f = lane > k && lane < 7 ? row[k] * __frcp_rn(pr[k]) : 0.f;  // no branch
#pragma unroll
        for (int j = k + 1; j < 8; ++j) row[j] = fmaf(-f, pr[j], row[j]);
    }
#pragma unroll
    for (int i = 6; i >= 0; --i) {
        x[i] = __shfl_sync(FULL, row[7] * __frcp_rn(row[i]), i);
        row[7] = fmaf(lane < i ? -row[i] : 0.f, x[i], row[7]);
    }
}

__global__ void __launch_bounds__(NT) sim3_lm_kernel(
    const PairsIn in, const float* __restrict__ s0, const float* __restrict__ R0,
    const float* __restrict__ t0, int N, Cam c, int fix_scale, int iters, float th,
    float* __restrict__ s_out, float* __restrict__ R_out, float* __restrict__ t_out,
    uint8_t* __restrict__ inlier_out, int* __restrict__ n_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ LmState st;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float4* stg = reinterpret_cast<float4*>(smem);
    uint16_t* idx = reinterpret_cast<uint16_t*>(smem + (size_t)N * STAGED_BYTES);
    uint8_t* mask = smem + (size_t)N * (STAGED_BYTES + 2);
    for (int i = tid; i < N; i += NT) inlier_out[i] = 0;
    const int nv = stage_valid(in, N, stg, idx, st.wcnt);
    if (tid == 0) {
        st.cur.s = *s0;
        for (int k = 0; k < 9; ++k) st.cur.R[k] = R0[k];
        for (int k = 0; k < 3; ++k) st.cur.t[k] = t0[k];
        st.lam = 1e-4f;
        st.n_inl = 0;
    }
    __syncthreads();

    for (int it = 0;; ++it) {
        // (b) at the current Sim3: the previous iteration's inlier refresh,
        // then (while it < iters) the linearization over the inliers
        const Sim S = st.cur;
        const bool lin = it < iters;
        const float si = 1.f / S.s;
        float acc[64];
#pragma unroll
        for (int k = 0; k < 64; ++k) acc[k] = 0.f;
        for (int p = tid; p < nv; p += NT) {
            const Pair q = load_staged(stg, p);
            const PairRes e = pair_res(c, S, q);
            const bool inl = it == 0 || (e.cf < th && e.ci < th && e.dok);
            mask[p] = inl ? 1 : 0;
            if (!lin || !inl) continue;
            acc[35] += pair_cost(e, th);
            const float chi2 = e.cf + e.ci;
            const float wh = chi2 > th ? sqrtf(th / fmaxf(chi2, 1e-12f)) : 1.f;
            if (!e.dok) continue;
            const float w = sqrtf(wh);
            // forward: p = y2, dp/dxi = [I, -hat(p), p]
            {
                const float px = e.y2[0], py = e.y2[1], pz = e.y2[2], iz = e.iz2;
                const float ws = w * sqrtf(q.i2);
                const float dP[3][7] = {{1.f, 0.f, 0.f, 0.f, pz, -py, px},
                                        {0.f, 1.f, 0.f, -pz, 0.f, px, py},
                                        {0.f, 0.f, 1.f, py, -px, 0.f, pz}};
                float Ju[7], Jv[7];
#pragma unroll
                for (int j = 0; j < 7; ++j) {
                    Ju[j] = ws * (c.fx * iz * dP[0][j] - c.fx * px * iz * iz * dP[2][j]);
                    Jv[j] = ws * (c.fy * iz * dP[1][j] - c.fy * py * iz * iz * dP[2][j]);
                }
                add_row(acc, Ju, w * e.r[0]);
                add_row(acc, Jv, w * e.r[1]);
            }
            // inverse: q = y1, dq/dxi = -(1/s) R^T [I, -hat(x2), x2]
            {
                const float* b = q.b;
                const float qx = e.y1[0], qy = e.y1[1], iz = e.iz1;
                const float ws = w * sqrtf(q.i1);
                const float G[3][7] = {{1.f, 0.f, 0.f, 0.f, b[2], -b[1], b[0]},
                                       {0.f, 1.f, 0.f, -b[2], 0.f, b[0], b[1]},
                                       {0.f, 0.f, 1.f, b[1], -b[0], 0.f, b[2]}};
                float dQ[3][7];
#pragma unroll
                for (int i = 0; i < 3; ++i)
#pragma unroll
                    for (int j = 0; j < 7; ++j)
                        dQ[i][j] = -si * ((S.R[i] * G[0][j] + S.R[3 + i] * G[1][j]) + S.R[6 + i] * G[2][j]);
                float Ju[7], Jv[7];
#pragma unroll
                for (int j = 0; j < 7; ++j) {
                    Ju[j] = ws * (c.fx * iz * dQ[0][j] - c.fx * qx * iz * iz * dQ[2][j]);
                    Jv[j] = ws * (c.fy * iz * dQ[1][j] - c.fy * qy * iz * iz * dQ[2][j]);
                }
                add_row(acc, Ju, w * e.r[2]);
                add_row(acc, Jv, w * e.r[3]);
            }
        }
        if (!lin) break;
        transpose_sum(acc, lane);
        if (2 * lane < NACC) st.part[warp][2 * lane] = acc[0];
        if (2 * lane + 1 < NACC) st.part[warp][2 * lane + 1] = acc[1];
        __syncthreads();
        if (tid < NACC) {
            float s = 0.f;
            for (int w = 0; w < NWARP; ++w) s += st.part[w][tid];
            st.red[tid] = s;
        }
        __syncthreads();

        // (c) the damping ladder: a warp per lambda, a lane per row
        if (warp < 3) {
            const int i = lane;
            float row[8];
#pragma unroll
            for (int j = 0; j < 7; ++j) {
                const int lo = i < j ? i : j, hi = i < j ? j : i;
                float v = i < 7 ? st.red[lo * 7 - lo * (lo - 1) / 2 + (hi - lo)] : 0.f;
                if (fix_scale && (i == 6 || j == 6)) v = i == j ? 1.f : 0.f;
                row[j] = v;
            }
            row[7] = i < 7 && !(fix_scale && i == 6) ? st.red[28 + i] : 0.f;
            const float lam_k = st.lam * c_ladder[warp];
#pragma unroll
            for (int j = 0; j < 7; ++j)
                if (j == i) row[j] = (row[j] + lam_k * row[j]) + 1e-8f;
            float x[7];
            solve7_rows(row, lane, x);
            if (lane == 0) {
                float dx[7];
#pragma unroll
                for (int j = 0; j < 7; ++j) dx[j] = -x[j];
                if (fix_scale) dx[6] = 0.f;
                sim3_retract(dx, S, st.cand[warp]);
            }
        }
        __syncthreads();

        // (d) the three candidates' costs
        float cacc[3] = {0.f, 0.f, 0.f};
        for (int p = tid; p < nv; p += NT) {
            if (!mask[p]) continue;
            const Pair q = load_staged(stg, p);
#pragma unroll
            for (int k = 0; k < 3; ++k) cacc[k] += pair_cost(pair_res(c, st.cand[k], q), th);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float v = warp_sum(cacc[k]);
            if (lane == 0) st.cpart[warp][k] = v;
        }
        __syncthreads();

        // (e) accept the first improving lambda
        if (tid == 0) {
            const float cost = st.red[35];
            int pick = -1;
            for (int k = 0; k < 3 && pick < 0; ++k) {
                float ck = 0.f;
                for (int w = 0; w < NWARP; ++w) ck += st.cpart[w][k];
                if (ck < cost) pick = k;
            }
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
    }

    int cnt = 0;
    for (int p = tid; p < nv; p += NT) {
        inlier_out[idx[p]] = mask[p];
        cnt += mask[p];
    }
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(FULL, cnt, o);
    if (lane == 0) atomicAdd(&st.n_inl, cnt);
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
    const size_t smem = (size_t)N * (STAGED_BYTES + 3);    // pairs, indices, mask
    if (smem + STATIC_SMEM > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            sim3_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const PairsIn in = {x1, x2, uv1, uv2, is1, is2, valid};
    const Cam c = {fx, fy, cx, cy};
    sim3_lm_kernel<<<1, NT, smem, stream>>>(in, s0, R0, t0, N, c, fix_scale, iters, th, s, R, t,
                                            inlier, n);
    return (int)cudaGetLastError();
}
