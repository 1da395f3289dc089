// Kernel 9: a stereo frame's row-band match, SAD refinement, disparity,
// depth and acceptance, in one launch.
//
// Replaces (JAX reference): pipeline/frame.py _make_frame_stereo after the
// two extractions (:147-203): the candidate mask (:152-167), the dense
// [N, N] hamming_pairwise with its sentinel and argmin (:172-175), the
// acceptance at (TH_HIGH + TH_LOW) // 2 (:180), _sad_subpixel_refine
// (:90-125, :186), the disparity, depth and range test (:188-190) and the
// median-distance gate (:192-196).  On the main path N = 1024 left x 1024
// right keypoints and two f32 [480, 640] images.
//
// Bound: bytes.  The keypoints, descriptors and the patches the accepted
// rows read are ~1 MB (~0.29 us); the gate over N x M pairs, the candidates'
// 512-bit distances and the 9 x 81 SAD terms of an accepted row are ~0.22
// us of operations.  What costs is latency: the CTA's staging barriers and
// a row's dependent rounds (its candidates' descriptors, then its patches).
//
// Design: one warp a left keypoint, 8 a CTA.
//  (1) Staging.  Each CTA copies a 16-byte record per right keypoint (x, y,
//      octave) and the level scales to shared memory, and sorts the valid
//      keypoints' indices into bands of bh = 2^bs image rows (band =
//      floor(y) >> bs clamped to [0, nb)): counts by shared-memory atomics,
//      one a band a warp (__match_any_sync), a warp's scan for the band
//      starts, each index at its band's start plus its rank.
//      The record loads of the first round and the scales' meet at one
//      barrier, and the warp's own left row is loaded meanwhile.
//  (2) Gate.  A left row visits only the bands within R of its own, R =
//      floor(floor(tol_max) / bh) + 1 for tol_max the largest tolerance: a
//      candidate's float |yl - yr| <= tol rounds from a difference of at
//      most tol + half an ulp, below floor(tol_max) + 1, so its floored rows
//      differ by at most floor(tol_max) + 1 and its band by at most R
//      (kernels/stereo.py stereo_bands mirrors this, and a test shows the
//      superset).  The exact float gate, with the row tolerance 2
//      scales[clamp(octave)], runs on every visited keypoint, 32 at a time;
//      __ballot_sync appends the candidates to the warp's list.
//  (3) Distances.  One lane a listed candidate, its four 16-byte descriptor
//      loads issued together; each distance is packed with the index as
//      (d << 20 | j), so one warp minimum gives the first index of the
//      smallest distance whatever the order of the visits (jnp.argmin's
//      rule); a row without a candidate keeps (2048, 0).
//  (4) SAD.  For an accepted row the warp stages the left 9 x 9 patch and
//      the right 9 x 32 strip around the nine slide centres in one round of
//      loads, each pixel clamped to the image on its own (centres rounded
//      half to even).  Lanes 0-8 each sum one slide's 81 absolute
//      differences from shared memory in row-major order; shuffles bring the
//      nine sums together and every lane takes the first argmin, the
//      parabola and the depth.
//  (5) The median gate needs all N rows: each CTA adds its rows that are
//      not accepted to a per-device counter with the same 64-bit atomic that
//      takes its ticket (after __threadfence()), and the last CTA to finish
//      has the count from it.  When a row is
//      not accepted the reference's jnp.median is NaN, and NaN becomes 80;
//      when every row is, the last CTA takes the exact median of the integer
//      distances from a histogram.  It clears the rows above 2.1 x that
//      median, unless no accepted row can lie above it (th - 1 <= 2.1 x 80 =
//      168 in the first case, so at the main path's th = 159 the gate
//      removes nothing there).  It resets the counter and the ticket for the
//      next call.
//
// Bit for bit as the plain torch twin (kernels/stereo.py
// stereo_match_plain): +, -, x and / correctly rounded in the twin's order,
// built with --fmad=false; the SAD sums run term by term in the twin's
// order.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256
#define ROWS_PER_CTA (NT / 32)
#define WORDS 16             // 512-bit descriptors as int32 words
#define HALF 4               // 9 x 9 SAD patch
#define SLIDE 4              // 9 slides, -4 .. 4
#define WIN (2 * HALF + 1)
#define STRIP 32             // the right strip's columns, a lane each
#define LIST 64              // a warp's list of candidates
#define STAGE 4              // right keypoints a thread loads in one round
#define BAND_SHIFT 2         // 4 rows a band, unless the image needs more than MAX_BANDS
#define MAX_BANDS 1024
#define NO_MATCH 2048u       // the reference's sentinel distance
#define MAX_TH 513           // acceptance thresholds above 512 act as 513
#define MEDIAN_NAN 80.f      // jnp.nan_to_num's stand-in for the NaN median
#define FULL 0xffffffffu

struct StereoArgs {
    const float* xy_l;        // [N, 2] raw left keypoints
    const int* oct_l;         // [N]
    const uint8_t* valid_l;   // [N]
    const int* desc_l;        // [N, 16]
    const float* xy_r;        // [M, 2]
    const int* oct_r;         // [M]
    const uint8_t* valid_r;   // [M]
    const int* desc_r;        // [M, 16]
    const float* x_und;       // [N] undistorted left x
    const float* img_l;       // [H, W]
    const float* img_r;       // [H, W]
    const float* scales;      // [L] level scale factors
    int N, M, H, W, L, th;
    int bs, nb;               // 2^bs rows a band, nb bands
    float fx, bf;
    float* ur;                // [N] out: refined right x where ok, else -1
    float* depth;             // [N] out: depth where ok, else 0
    int* best;                // [N] out
    int* bestd;               // [N] out
    uint8_t* ok;              // [N] out
    unsigned* ws;             // [2], 8-byte aligned: ticket, rows not accepted; 0 between calls
};

// shared memory of fixed size; the records and band starts follow in dynamic memory
struct Fixed {
    int list[ROWS_PER_CTA][LIST];
    float pl[ROWS_PER_CTA][WIN * WIN];
    float pr[ROWS_PER_CTA][WIN][STRIP];
    int hist[MAX_TH + 1];
    int radius;
    unsigned bad;
    float thr;
    bool is_last;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// the band of row y: floor(y) / 2^bs, clamped (the conversion saturates, NaN gives 0)
__device__ __forceinline__ int band_of(float y, int bs, int nb) {
    const int r = (int)floorf(y);
    return r < 0 ? 0 : min(r >> bs, nb - 1);
}

// a patch centre rounded half to even, clamped where +-HALF pixels all clamp alike
__device__ __forceinline__ int centre(float v, int n) {
    return (int)fminf(fmaxf(rintf(v), -16.f), (float)(n + 16));
}

// the first smallest (distance << 20 | index) over the warp's listed candidates
__device__ unsigned list_min(const int* list, int n, const int4* dl, const int* desc_r, int lane) {
    unsigned key = NO_MATCH << 20;
    for (int k = lane; k < n; k += 32) {
        const int j = list[k];
        const int4* pr = reinterpret_cast<const int4*>(desc_r + (size_t)j * WORDS);
        const int4 v0 = pr[0], v1 = pr[1], v2 = pr[2], v3 = pr[3];
        const unsigned d =
            __popc(dl[0].x ^ v0.x) + __popc(dl[0].y ^ v0.y) + __popc(dl[0].z ^ v0.z) + __popc(dl[0].w ^ v0.w) +
            __popc(dl[1].x ^ v1.x) + __popc(dl[1].y ^ v1.y) + __popc(dl[1].z ^ v1.z) + __popc(dl[1].w ^ v1.w) +
            __popc(dl[2].x ^ v2.x) + __popc(dl[2].y ^ v2.y) + __popc(dl[2].z ^ v2.z) + __popc(dl[2].w ^ v2.w) +
            __popc(dl[3].x ^ v3.x) + __popc(dl[3].y ^ v3.y) + __popc(dl[3].z ^ v3.z) + __popc(dl[3].w ^ v3.w);
        key = min(key, (d << 20) | (unsigned)j);
    }
    __syncwarp();
    return key;
}

__global__ void __launch_bounds__(NT) stereo_match_kernel(StereoArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    float4* s_kp = reinterpret_cast<float4*>(smem);        // [M] x, y, octave, - by keypoint
    int* s_idx = reinterpret_cast<int*>(s_kp + a.M);       // [M] the valid keypoints by band
    int* s_rank = s_idx + a.M;                             // [M] a keypoint's rank in its band
    int* s_off = s_rank + a.M;                             // [nb + 1] band starts
    float* s_scale = reinterpret_cast<float*>(s_off + a.nb + 1);   // [L]
    __shared__ Fixed f;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // the warp's left row, loaded while the CTA stages the right keypoints
    const int i = blockIdx.x * ROWS_PER_CTA + warp;
    const bool row = i < a.N;
    float xl = 0.f, yl = 0.f, xu = 0.f;
    int ol = 0;
    bool vl = false;
    int4 dl[WORDS / 4];
    if (row) {
        xl = __ldg(&a.xy_l[2 * i]);
        yl = __ldg(&a.xy_l[2 * i + 1]);
        xu = __ldg(&a.x_und[i]);
        ol = __ldg(&a.oct_l[i]);
        vl = __ldg(&a.valid_l[i]);
        const int4* pl = reinterpret_cast<const int4*>(a.desc_l + (size_t)i * WORDS);
#pragma unroll
        for (int q = 0; q < WORDS / 4; ++q) dl[q] = __ldg(&pl[q]);
    }

    // (1) staging: the valid right keypoints sorted into bands.  A thread
    // takes STAGE keypoints a round (one round when M <= STAGE x NT) and
    // issues each step's STAGE operations before it uses one; the first
    // round's loads meet the level scales' at the first barrier.
    float2 p[STAGE];
    int r[STAGE];
    bool v[STAGE];
    const bool one_round = a.M <= STAGE * NT;
    // a thread takes keypoints j0 + u NT + spread, spread = 37 tid mod NT: a
    // warp's lanes take keypoints 37 apart, since extraction order puts
    // neighbours in one band and a warp's atomics on one address serialize
    const int spread = (tid * 37) & (NT - 1);
    const auto load = [&](int j0) {
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
            const int j = j0 + u * NT + spread;
            v[u] = false;
            if (j < a.M) {
                v[u] = __ldg(&a.valid_r[j]);
                p[u] = __ldg(reinterpret_cast<const float2*>(a.xy_r) + j);
                s_kp[j] = make_float4(p[u].x, p[u].y, __int_as_float(__ldg(&a.oct_r[j])), 0.f);
            }
        }
    };
    load(0);
    for (int k = tid; k <= a.nb; k += NT) s_off[k] = 0;
    for (int l = tid; l < a.L; l += NT) s_scale[l] = __ldg(&a.scales[l]);
    if (tid == 0) f.bad = 0u;
    __syncthreads();
    for (int j0 = 0; j0 < a.M; j0 += STAGE * NT) {
        if (j0 > 0) load(j0);
#pragma unroll
        for (int u = 0; u < STAGE; ++u)        // a keypoint's rank in its band
            r[u] = v[u] ? atomicAdd(&s_off[band_of(p[u].y, a.bs, a.nb) + 1], 1) : -1;
        if (!one_round)
#pragma unroll
            for (int u = 0; u < STAGE; ++u)
                if (j0 + u * NT + spread < a.M) s_rank[j0 + u * NT + spread] = r[u];
    }
    __syncthreads();
    if (tid == 32) {                            // the band radius, beside warp 0's scan
        float tol_max = 0.f;
        for (int l = 0; l < a.L; ++l) tol_max = fmaxf(tol_max, 2.0f * s_scale[l]);
        f.radius = tol_max < 1e9f ? min(((int)floorf(tol_max) >> a.bs) + 1, a.nb) : a.nb;
    }
    if (warp == 0) {
        // band starts: lane k sums its run of per consecutive counts, one warp scan
        // of the runs, then each lane writes its run's starts
        const int per = (a.nb + 31) / 32, k0 = 1 + lane * per, k1 = min(k0 + per, a.nb + 1);
        int run = 0;
#pragma unroll 4
        for (int k = k0; k < k1; ++k) run += s_off[k];
        int incl = run;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(FULL, incl, d);
            if (lane >= d) incl += t;
        }
        int start = incl - run;
#pragma unroll 4
        for (int k = k0; k < k1; ++k) {
            start += s_off[k];
            s_off[k] = start;
        }
    }
    __syncthreads();
    for (int j0 = 0; j0 < a.M; j0 += STAGE * NT) {  // each keypoint to its band's start + rank
        int pos[STAGE];
        if (!one_round)
#pragma unroll
            for (int u = 0; u < STAGE; ++u) {
                const int j = j0 + u * NT + spread;
                r[u] = j < a.M ? s_rank[j] : -1;
                if (r[u] >= 0) p[u].y = s_kp[j].y;
            }
#pragma unroll
        for (int u = 0; u < STAGE; ++u)
            if (r[u] >= 0) pos[u] = s_off[band_of(p[u].y, a.bs, a.nb)] + r[u];
#pragma unroll
        for (int u = 0; u < STAGE; ++u)
            if (r[u] >= 0) s_idx[pos[u]] = j0 + u * NT + spread;
    }
    __syncthreads();

    if (row) {
        // (2)-(3) the visited bands' candidates and the first best distance
        unsigned key = NO_MATCH << 20;
        if (vl) {
            const int bl = band_of(yl, a.bs, a.nb), R = f.radius;
            const int p0 = s_off[max(bl - R, 0)], p1 = s_off[min(bl + R, a.nb - 1) + 1];
            int* list = f.list[warp];
            int n = 0;                              // listed candidates, the same on every lane
            for (int c = p0; c < p1; c += 32) {
                const int at = c + lane;
                int j = 0;
                bool cand = false;
                if (at < p1) {
                    j = s_idx[at];
                    const float4 kp = s_kp[j];
                    const int orr = __float_as_int(kp.z);
                    const float disp = xl - kp.x;
                    cand = fabsf(yl - kp.y) <= 2.0f * s_scale[clampi(orr, 0, a.L - 1)] &&
                           disp >= 0.f && disp <= a.fx && abs(ol - orr) <= 1;
                }
                const unsigned m = __ballot_sync(FULL, cand);
                if (n + __popc(m) > LIST) {
                    key = min(key, list_min(list, n, dl, a.desc_r, lane));
                    n = 0;
                }
                if (cand) list[n + __popc(m & ((1u << lane) - 1u))] = j;
                n += __popc(m);
                __syncwarp();
            }
            key = min(key, list_min(list, n, dl, a.desc_r, lane));
        }
        key = __reduce_min_sync(FULL, key);
        const int b = (int)(key & 0xfffffu), bd = (int)(key >> 20);
        bool ok = bd < a.th;

        // (4) SAD refinement of an accepted row, disparity and depth
        float ur = -1.f, depth = 0.f;
        if (ok) {
            const float4 kb = s_kp[b];                    // a candidate's record
            const float ur0 = kb.x, yr = kb.y;
            const int cxl = centre(xl, a.W), cyl = centre(yl, a.H), cyr = centre(yr, a.H);
            const int cxr = centre(ur0 + (float)(lane - SLIDE), a.W);    // lane o < 9: slide o - 4
            const int base = __shfl_sync(FULL, cxr, 0) - HALF;            // the strip's first column
            float* s_pl = f.pl[warp];
            float(*s_pr)[STRIP] = f.pr[warp];
            for (int k = lane; k < WIN * WIN; k += 32)
                s_pl[k] = a.img_l[(size_t)clampi(cyl + k / WIN - HALF, 0, a.H - 1) * a.W +
                                  clampi(cxl + k % WIN - HALF, 0, a.W - 1)];
            const int col = clampi(base + lane, 0, a.W - 1);
#pragma unroll
            for (int r = 0; r < WIN; ++r)
                s_pr[r][lane] = a.img_r[(size_t)clampi(cyr + r - HALF, 0, a.H - 1) * a.W + col];
            __syncwarp();
            float s = 0.f;
            if (lane <= 2 * SLIDE) {
                const int off = cxr - base - HALF;        // 0 .. 10: the centres are monotone
                for (int dy = 0; dy < WIN; ++dy)
#pragma unroll
                    for (int dx = 0; dx < WIN; ++dx)
                        s = s + fabsf(s_pl[dy * WIN + dx] - s_pr[dy][off + dx]);
            }
            float s_min = __shfl_sync(FULL, s, 0);
            int jmin = 0;
#pragma unroll
            for (int k = 1; k <= 2 * SLIDE; ++k) {
                const float v = __shfl_sync(FULL, s, k);
                if (v < s_min) {
                    s_min = v;
                    jmin = k;
                }
            }
            const int jc = clampi(jmin, 1, 2 * SLIDE - 1);
            const float s_m = __shfl_sync(FULL, s, jc - 1), s_0 = __shfl_sync(FULL, s, jc),
                        s_p = __shfl_sync(FULL, s, jc + 1);
            const float denom = fmaxf(s_m + s_p - 2.0f * s_0, 1e-6f);
            const float delta = fminf(fmaxf(0.5f * (s_m - s_p) / denom, -1.f), 1.f);
            const float u = ur0 + (float)(jc - SLIDE) + delta;
            const float disp = xu - u;
            ok = disp > 0.1f && disp < a.fx;
            if (ok) {
                ur = u;
                depth = a.bf / fmaxf(disp, 0.1f);
            }
        }
        if (lane == 0) {
            a.best[i] = b;
            a.bestd[i] = bd;
            a.ok[i] = ok;
            a.ur[i] = ur;
            a.depth[i] = depth;
            if (!ok) atomicAdd(&f.bad, 1u);
        }
    }

    // (5) the median gate, by the last CTA
    __syncthreads();
    if (tid == 0) {
        // the ticket (low word) and the rows not accepted (high word) in one atomic
        __threadfence();
        const unsigned long long old = atomicAdd(reinterpret_cast<unsigned long long*>(a.ws),
                                                 1ull | (unsigned long long)f.bad << 32);
        f.is_last = (unsigned)old == gridDim.x - 1;
        f.bad += (unsigned)(old >> 32);
    }
    __syncthreads();
    if (!f.is_last) return;
    __threadfence();
    const unsigned bad = f.bad;                // every CTA's
    if (tid == 0) *reinterpret_cast<unsigned long long*>(a.ws) = 0ull;
    if (a.N == 0) return;
    if (bad != 0u) {
        // the reference's median is NaN, and NaN becomes 80
        if (tid == 0) f.thr = 2.1f * MEDIAN_NAN;
    } else {
        const int nb = min(a.th, MAX_TH);          // every row accepted: distances < nb
        for (int k = tid; k <= MAX_TH; k += NT) f.hist[k] = 0;
        __syncthreads();
        for (int r = tid; r < a.N; r += NT) atomicAdd(&f.hist[__ldcg(&a.bestd[r])], 1);
        __syncthreads();
        if (tid == 0) {
            // the values at ranks (N - 1) / 2 and N / 2, ascending
            const int r0 = (a.N - 1) / 2, r1 = a.N / 2;
            int v0 = -1, v1 = -1, seen = 0;
            for (int v = 0; v < nb && v1 < 0; ++v) {
                seen += f.hist[v];
                if (v0 < 0 && seen > r0) v0 = v;
                if (seen > r1) v1 = v;
            }
            f.thr = 2.1f * (((float)v0 + (float)v1) * 0.5f);
        }
    }
    __syncthreads();
    const float thr = f.thr;
    if ((float)(a.th - 1) <= thr) return;     // an accepted row's distance is below th
    for (int r = tid; r < a.N; r += NT)
        if ((float)__ldcg(&a.bestd[r]) > thr) {
            a.ok[r] = 0;
            a.ur[r] = -1.f;
            a.depth[r] = 0.f;
        }
}

// The kernel's static shared memory, sizeof(Fixed), as the runtime counts it
// (kernels/stereo.py FIXED_SMEM mirrors it); a negative CUDA error on failure.
extern "C" int stereo_match_static_smem() {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, stereo_match_kernel);
    return e == cudaSuccess ? (int)attr.sharedSizeBytes : -(int)e;
}

// ws [2] holds 0 between calls.
extern "C" int stereo_match_launch(const float* xy_l, const int* oct_l, const uint8_t* valid_l,
                                   const int* desc_l, const float* xy_r, const int* oct_r,
                                   const uint8_t* valid_r, const int* desc_r, const float* x_und,
                                   const float* img_l, const float* img_r, const float* scales,
                                   int N, int M, int H, int W, int L, int th, float fx, float bf,
                                   float* ur, float* depth, int* best, int* bestd, uint8_t* ok,
                                   unsigned* ws, cudaStream_t stream) {
    if (N == 0) return (int)cudaGetLastError();
    if (M <= 0 || M >= (1 << 20) || th < 0 || th > (int)NO_MATCH || L <= 0 || H <= 0 || W <= 0 ||
        H >= (1 << 23) || W >= (1 << 23))
        return (int)cudaErrorInvalidValue;
    int bs = BAND_SHIFT;                     // 4 rows a band, more if H needs more than MAX_BANDS
    while ((H + (1 << bs) - 1) >> bs > MAX_BANDS) ++bs;
    const int nb = (H + (1 << bs) - 1) >> bs;
    const size_t smem = (size_t)M * (sizeof(float4) + 2 * sizeof(int)) +
                        (size_t)(nb + 1) * sizeof(int) + (size_t)L * sizeof(float);
    if (smem + sizeof(Fixed) > 48 * 1024) {    // not at M = 1024
        const cudaError_t e = cudaFuncSetAttribute(
            stereo_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    StereoArgs a;
    a.xy_l = xy_l; a.oct_l = oct_l; a.valid_l = valid_l; a.desc_l = desc_l;
    a.xy_r = xy_r; a.oct_r = oct_r; a.valid_r = valid_r; a.desc_r = desc_r;
    a.x_und = x_und; a.img_l = img_l; a.img_r = img_r; a.scales = scales;
    a.N = N; a.M = M; a.H = H; a.W = W; a.L = L; a.th = th;
    a.bs = bs; a.nb = nb;
    a.fx = fx; a.bf = bf;
    a.ur = ur; a.depth = depth; a.best = best; a.bestd = bestd; a.ok = ok; a.ws = ws;
    stereo_match_kernel<<<(N + ROWS_PER_CTA - 1) / ROWS_PER_CTA, NT, smem, stream>>>(a);
    return (int)cudaGetLastError();
}
