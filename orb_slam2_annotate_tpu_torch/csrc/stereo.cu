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
// Bound: operations.  ~1024 x 1024 pairs pass through the gate (~12
// operations each), the few candidates in a row band take a 512-bit
// Hamming distance (48), and every accepted row slides 9 SAD windows of
// 81 pixels (~4 operations a term).  The bytes (keypoints, descriptors and
// the patches read) are well under a megabyte.
//
// Design: one warp a left keypoint, 8 a CTA.  The CTA stages the right
// keypoints' xy, octave and validity in shared memory.  Lane k tests right
// keypoints k, k + 32, ...; a candidate's descriptor is read from global
// memory and its distance packed with its index as (d << 20 | j), so one
// warp minimum gives the first index of the smallest distance, as
// jnp.argmin does; a row without a candidate keeps (2048, 0).  An accepted
// row's lanes 0-8 each sum one slide's 81 absolute differences in row-major
// order (patch centres rounded half to even, each pixel clamped to the
// image on its own); the nine sums meet by shuffles and every lane takes
// the first argmin, the parabola and the depth.  The median gate needs all
// N rows: each CTA adds its rows that are not accepted to a per-device
// counter, and the last CTA to finish (an atomic ticket taken after
// __threadfence()) reads it.  When a row is not accepted the reference's
// jnp.median is NaN, and NaN becomes 80; when every row is, the last CTA
// takes the exact median of the integer distances from a histogram.  It
// clears the rows above 2.1 x that median, unless no accepted row can lie
// above it (th - 1 <= 2.1 x 80 = 168 in the first case, so at the main
// path's th = 159 the gate removes nothing there).  It resets the counter
// and the ticket for the next call.
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
    float fx, bf;
    float* ur;                // [N] out: refined right x where ok, else -1
    float* depth;             // [N] out: depth where ok, else 0
    int* best;                // [N] out
    int* bestd;               // [N] out
    uint8_t* ok;              // [N] out
    unsigned* ws;             // [2]: ticket, rows not accepted; 0 between calls
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// one slide's SAD: 81 terms in row-major order, every pixel clamped on its own
__device__ float sad_slide(const float* img_l, const float* img_r, int H, int W, int xl, int yl,
                           int xr, int yr) {
    float s = 0.f;
    for (int dy = -HALF; dy <= HALF; ++dy) {
        const float* row_l = img_l + (size_t)clampi(yl + dy, 0, H - 1) * W;
        const float* row_r = img_r + (size_t)clampi(yr + dy, 0, H - 1) * W;
#pragma unroll
        for (int dx = -HALF; dx <= HALF; ++dx)
            s = s + fabsf(row_l[clampi(xl + dx, 0, W - 1)] - row_r[clampi(xr + dx, 0, W - 1)]);
    }
    return s;
}

__global__ void __launch_bounds__(NT) stereo_match_kernel(StereoArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    float2* s_xy = reinterpret_cast<float2*>(smem);
    int* s_oct = reinterpret_cast<int*>(s_xy + a.M);
    uint8_t* s_val = reinterpret_cast<uint8_t*>(s_oct + a.M);
    __shared__ unsigned s_bad;
    __shared__ bool is_last;
    __shared__ int s_hist[MAX_TH + 1];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_bad = 0u;
    for (int j = tid; j < a.M; j += NT) {
        s_xy[j] = reinterpret_cast<const float2*>(a.xy_r)[j];
        s_oct[j] = a.oct_r[j];
        s_val[j] = a.valid_r[j];
    }
    __syncthreads();

    const int i = blockIdx.x * ROWS_PER_CTA + warp;
    if (i < a.N) {
        // (1)-(2) the row-band candidates and the first best distance
        const float xl = a.xy_l[2 * i], yl = a.xy_l[2 * i + 1];
        const int ol = a.oct_l[i];
        unsigned key = NO_MATCH << 20;
        if (a.valid_l[i]) {
            int dl[WORDS];
            const int4* pl = reinterpret_cast<const int4*>(a.desc_l + (size_t)i * WORDS);
#pragma unroll
            for (int q = 0; q < WORDS / 4; ++q) {
                const int4 v = pl[q];
                dl[4 * q] = v.x; dl[4 * q + 1] = v.y; dl[4 * q + 2] = v.z; dl[4 * q + 3] = v.w;
            }
            for (int j = lane; j < a.M; j += 32) {
                const float2 r = s_xy[j];
                const int orr = s_oct[j];
                const float row_tol = 2.0f * a.scales[clampi(orr, 0, a.L - 1)];
                const float disp = xl - r.x;
                const bool cand = fabsf(yl - r.y) <= row_tol && disp >= 0.f && disp <= a.fx &&
                                  s_val[j] && abs(ol - orr) <= 1;
                if (!cand) continue;
                const int4* pr = reinterpret_cast<const int4*>(a.desc_r + (size_t)j * WORDS);
                unsigned d = 0;
#pragma unroll
                for (int q = 0; q < WORDS / 4; ++q) {
                    const int4 v = pr[q];
                    d += __popc((unsigned)(dl[4 * q] ^ v.x)) + __popc((unsigned)(dl[4 * q + 1] ^ v.y)) +
                         __popc((unsigned)(dl[4 * q + 2] ^ v.z)) + __popc((unsigned)(dl[4 * q + 3] ^ v.w));
                }
                key = min(key, (d << 20) | (unsigned)j);
            }
        }
        key = __reduce_min_sync(FULL, key);
        const int b = (int)(key & 0xfffffu), bd = (int)(key >> 20);
        bool ok = bd < a.th;

        // (3)-(4) SAD refinement of an accepted row, disparity and depth
        float ur = -1.f, depth = 0.f;
        if (ok) {
            const float ur0 = a.xy_r[2 * b], yr = a.xy_r[2 * b + 1];
            float s = 0.f;
            if (lane <= 2 * SLIDE)
                s = sad_slide(a.img_l, a.img_r, a.H, a.W, (int)rintf(xl), (int)rintf(yl),
                              (int)rintf(ur0 + (float)(lane - SLIDE)), (int)rintf(yr));
            float sads[2 * SLIDE + 1];
#pragma unroll
            for (int k = 0; k <= 2 * SLIDE; ++k) sads[k] = __shfl_sync(FULL, s, k);
            int jmin = 0;
#pragma unroll
            for (int k = 1; k <= 2 * SLIDE; ++k)
                if (sads[k] < sads[jmin]) jmin = k;
            const int jc = clampi(jmin, 1, 2 * SLIDE - 1);
            float s_m = 0.f, s_0 = 0.f, s_p = 0.f;
#pragma unroll
            for (int k = 1; k < 2 * SLIDE; ++k)
                if (k == jc) {
                    s_m = sads[k - 1];
                    s_0 = sads[k];
                    s_p = sads[k + 1];
                }
            const float denom = fmaxf(s_m + s_p - 2.0f * s_0, 1e-6f);
            const float delta = fminf(fmaxf(0.5f * (s_m - s_p) / denom, -1.f), 1.f);
            const float u = ur0 + (float)(jc - SLIDE) + delta;
            const float disp = a.x_und[i] - u;
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
            if (!ok) atomicAdd(&s_bad, 1u);
        }
    }

    // (5) the median gate, by the last CTA
    __syncthreads();
    if (tid == 0) {
        if (s_bad) atomicAdd(&a.ws[1], s_bad);
        __threadfence();
        is_last = atomicAdd(&a.ws[0], 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const unsigned bad = __ldcg(&a.ws[1]);
    __syncthreads();
    if (tid == 0) {
        a.ws[0] = 0u;
        a.ws[1] = 0u;
    }
    if (a.N == 0) return;
    __shared__ float s_thr;
    if (bad != 0u) {
        // the reference's median is NaN, and NaN becomes 80
        if (tid == 0) s_thr = 2.1f * MEDIAN_NAN;
    } else {
        const int nb = min(a.th, MAX_TH);          // every row accepted: distances < nb
        for (int k = tid; k <= MAX_TH; k += NT) s_hist[k] = 0;
        __syncthreads();
        for (int r = tid; r < a.N; r += NT) atomicAdd(&s_hist[__ldcg(&a.bestd[r])], 1);
        __syncthreads();
        if (tid == 0) {
            // the values at ranks (N - 1) / 2 and N / 2, ascending
            const int r0 = (a.N - 1) / 2, r1 = a.N / 2;
            int v0 = -1, v1 = -1, seen = 0;
            for (int v = 0; v < nb && v1 < 0; ++v) {
                seen += s_hist[v];
                if (v0 < 0 && seen > r0) v0 = v;
                if (seen > r1) v1 = v;
            }
            s_thr = 2.1f * (((float)v0 + (float)v1) * 0.5f);
        }
    }
    __syncthreads();
    const float thr = s_thr;
    if ((float)(a.th - 1) <= thr) return;     // an accepted row's distance is below th
    for (int r = tid; r < a.N; r += NT)
        if ((float)__ldcg(&a.bestd[r]) > thr) {
            a.ok[r] = 0;
            a.ur[r] = -1.f;
            a.depth[r] = 0.f;
        }
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
    if (M <= 0 || M >= (1 << 20) || th < 0 || th > (int)NO_MATCH) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)M * (sizeof(float2) + sizeof(int) + 1);
    if (smem > 40 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            stereo_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    StereoArgs a;
    a.xy_l = xy_l; a.oct_l = oct_l; a.valid_l = valid_l; a.desc_l = desc_l;
    a.xy_r = xy_r; a.oct_r = oct_r; a.valid_r = valid_r; a.desc_r = desc_r;
    a.x_und = x_und; a.img_l = img_l; a.img_r = img_r; a.scales = scales;
    a.N = N; a.M = M; a.H = H; a.W = W; a.L = L; a.th = th;
    a.fx = fx; a.bf = bf;
    a.ur = ur; a.depth = depth; a.best = best; a.bestd = bestd; a.ok = ok; a.ws = ws;
    stereo_match_kernel<<<(N + ROWS_PER_CTA - 1) / ROWS_PER_CTA, NT, smem, stream>>>(a);
    return (int)cudaGetLastError();
}
