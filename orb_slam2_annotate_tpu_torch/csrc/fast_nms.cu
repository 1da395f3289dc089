// A frame's whole image pyramid in one launch: resize, 7-tap Gaussian blur,
// FAST-9/16 score, 3x3 non-maximum suppression and the EDGE margin, for
// every level.
//
// Replaces (JAX reference, fused by XLA per level): ops/pyramid.py
// build_pyramid and gaussian_blur, ops/fast.py fast_score_map and nms3x3,
// the margin mask of ops/extractor.py _select_level, and the padded stacks
// of ops/extractor.py _extract_jit.
//
// Outputs, each an [L,H0,W0] stack, zero outside level l's (h, w): pyr3 (the
// levels), pyr3_blur (reflect-101 blur at each level's own border), score
// (thresholded FAST after NMS and margin) and is_hi (uint8).
//
// Bound: bytes.  The image in (1.2 MB at VGA) and the four stacks out
// (13 B a stack pixel, 32 MB at VGA x 8 levels) take ~10 us at 3.35 TB/s;
// the operations (the resize taps, 14 blur multiply-adds and the FAST arcs
// per level pixel) weigh about the same.  No level image, blurred image or
// unsuppressed score map goes to device memory and comes back.
//
// Design: a 1-D grid of work items, one CTA of 256 threads each: first the
// tiles of every level (TX x TY pixels, the top level's first: its taps are
// the most), then bands of PAD_ROWS rows of each level's padding.
//  - Resize, separable: every level is resized from level 0 (as the
//    reference does), so the tiles are independent.  A tile and its 4-pixel
//    halo need output rows ya..yb and columns xa..xb.  The row pass forms
//    t(y, X) = sum_ky rw[ky] * img[min(fy + ky, H0 - 1), X] once for each
//    such row y and each input column X the column pass reads (coalesced
//    reads of the level-0 image, into shared memory), the column pass
//    out(y, x) = sum_kx cw[kx] * t(y, min(fx + kx, W0 - 1)).  resize_stack's
//    inner sum depends only on (y, X), so computing it once keeps its bits;
//    the outer sum keeps its order.  The level's sizes and taps are launch
//    parameters and the tile's tap tables are staged in shared memory first;
//    a warp takes a row, each lane four columns whose image loads issue
//    together: the first design's time went to dependent loads and index
//    arithmetic, not to its sums.  Where the footprint is wider
//    than TCAP columns (levels 5-7 at 1.2) the tile's columns go in chunks.
//  - FAST by window doubling: the minimum over the 9-arc from s is
//    min(m8[s], d[s + 8]), m2[s] = min(d[s], d[s + 1]), m4[s] = min(m2[s],
//    m2[s + 2]), m8[s] = min(m4[s], m4[s + 4]): ~80 min / max a polarity, not
//    ~144; the dark polarity is -(min_s of the 9-arc maximum).  A compass
//    pretest skips both: every 9-arc holds two cyclically adjacent points of
//    {0, 4, 8, 12}, so if no such pair exceeds thr_lo in a polarity, its
//    strength is <= thr_lo, and a pixel with neither polarity scores 0 and is
//    not "hi" (thr_hi >= thr_lo).  The positions that pass go to their warp's
//    list in shared memory and their arcs run 32 to a warp step.  Min, max
//    and negation are exact; a signed zero can differ only at a value <=
//    thr_lo (>= 0, checked by the wrapper), which scores 0.
//  - Blur and NMS read shared memory only, in the previous design's order:
//    the blur's vertical pass into a [TY, TX + 6] strip, its horizontal pass,
//    the thresholded score of the tile and a 1-pixel halo, its 3x3 maximum.
//  - Padding: a warp a row, its part outside the level (columns w..W0 - 1, or
//    the whole row below h) zeroed in all four stacks with 16-byte stores.
//    Tiles write only the level's own pixels.
//
// Bit for bit as the plain torch version (ops/pyramid.py resize_stack and
// gaussian_blur, kernels/fast_nms.py fast_nms_plain) and as the previous
// design: the same taps summed in the same order from 0, the blur's terms in
// gaussian_blur's order, compiled with --fmad=false; comparisons and
// min / max are exact.

#include <cuda_runtime.h>
#include <stdint.h>

#define TX 64
#define TY 16
#define HALO 4
#define SW (TX + 2 * HALO)
#define SH (TY + 2 * HALO)
#define NT 256
#define MAXL 16
#define TCAP 144           // row-pass columns in shared memory (a chunk of the footprint)
#define TT 32              // taps a level may have: the tile's tap tables in shared memory
#define PAD_ROWS 8         // a padding item: a row a warp
#define NPOS ((TY + 2) * (TX + 2))             // FAST positions of a tile: it and a 1-pixel halo
#define WLIST (((NPOS + NT - 1) / NT) * 32)    // a warp's share of them

__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// Field order and types mirror kernels/fast_nms.py:_PyrArgs.
struct PyrArgs {
    const float* img;                               // [H0,W0]
    const int* row_first; const float* row_w;       // [L,H0], [L,H0,T]
    const int* col_first; const float* col_w;       // [L,W0], [L,W0,T]
    float* pyr3; float* blur; float* score; uint8_t* is_hi;   // [L,H0,W0]
    float k[7];                                     // blur taps
    float thr_lo, thr_hi;
    int H0, W0, T, margin, n_levels;
    // first work item of each segment: segment s < L holds the tiles of level
    // L - 1 - s, segment L + l the padding bands of level l; seg[2L] = grid
    int seg[2 * MAXL + 1];
    int hw[2 * MAXL];                               // each level's (h, w)
    int taps[2 * MAXL];                             // each level's row, column taps
};

// max over the 16 starts of the min over the 9-arc from the start
__device__ __forceinline__ float arc_bright(const float (&d)[16]) {
    float m2[16], m4[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) m2[s] = fminf(d[s], d[(s + 1) & 15]);
#pragma unroll
    for (int s = 0; s < 16; ++s) m4[s] = fminf(m2[s], m2[(s + 2) & 15]);
    float best = -INFINITY;
#pragma unroll
    for (int s = 0; s < 16; ++s) best = fmaxf(best, fminf(fminf(m4[s], m4[(s + 4) & 15]), d[(s + 8) & 15]));
    return best;
}

// min over the 16 starts of the max over the 9-arc from the start
__device__ __forceinline__ float arc_dark(const float (&d)[16]) {
    float m2[16], m4[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) m2[s] = fmaxf(d[s], d[(s + 1) & 15]);
#pragma unroll
    for (int s = 0; s < 16; ++s) m4[s] = fmaxf(m2[s], m2[(s + 2) & 15]);
    float worst = INFINITY;
#pragma unroll
    for (int s = 0; s < 16; ++s) worst = fminf(worst, fmaxf(fmaxf(m4[s], m4[(s + 4) & 15]), d[(s + 8) & 15]));
    return worst;
}

__device__ __forceinline__ int reflect101(int i, int n) {
    return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// zero n floats / bytes from p, one warp, 16-byte stores where aligned
__device__ __forceinline__ void zero_f32(float* p, int n, int lane) {
    const int head = min(n, (int)(((16 - ((uintptr_t)p & 15)) & 15) >> 2));
    if (lane < head) p[lane] = 0.0f;
    float4* q = reinterpret_cast<float4*>(p + head);
    const int n4 = (n - head) >> 2;
    for (int i = lane; i < n4; i += 32) q[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const int tail = head + 4 * n4 + lane;
    if (tail < n) p[tail] = 0.0f;
}
__device__ __forceinline__ void zero_u8(uint8_t* p, int n, int lane) {
    const int head = min(n, (int)((16 - ((uintptr_t)p & 15)) & 15));
    if (lane < head) p[lane] = 0;
    uint4* q = reinterpret_cast<uint4*>(p + head);
    const int n16 = (n - head) >> 4;
    for (int i = lane; i < n16; i += 32) q[i] = make_uint4(0u, 0u, 0u, 0u);
    const int tail = head + 16 * n16 + lane;
    if (tail < n) p[tail] = 0;
}

__global__ void __launch_bounds__(NT) pyramid_fast_nms(const PyrArgs a) {
    __shared__ float S[SH][SW];                      // the level's tile + 4-pixel halo
    __shared__ __align__(16) float T[SH * TCAP];     // the row pass; then SC and V
    __shared__ int s_rf[SH], s_cf[SW];               // the tile's first taps and weights
    __shared__ float s_rw[SH][TT], s_cw[SW][TT];
    __shared__ unsigned short flist[NT / 32][WLIST]; // a warp's positions that pass the pretest
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, item = blockIdx.x, L = a.n_levels;
    int s = 0;
    while (item >= a.seg[s + 1]) ++s;
    const int l = s < L ? L - 1 - s : s - L;
    const int h = a.hw[2 * l], w = a.hw[2 * l + 1];
    const size_t plane = (size_t)l * a.H0 * a.W0;

    if (s >= L) {                                    // a band of padding rows
        const int y = (item - a.seg[s]) * PAD_ROWS + warp;
        if (y < a.H0) {
            const int c0 = y < h ? w : 0;
            const size_t o = plane + (size_t)y * a.W0 + c0;
            const int n = a.W0 - c0;
            zero_f32(a.pyr3 + o, n, lane);
            zero_f32(a.blur + o, n, lane);
            zero_f32(a.score + o, n, lane);
            zero_u8(a.is_hi + o, n, lane);
        }
        return;
    }
    const int tiles_x = (w + TX - 1) / TX, t = item - a.seg[s];
    const int x0 = (t % tiles_x) * TX, y0 = (t / tiles_x) * TY;
    const int ty = a.taps[2 * l], tx = a.taps[2 * l + 1];
    const int* rfirst = a.row_first + (size_t)l * a.H0;
    const float* rw = a.row_w + (size_t)l * a.H0 * a.T;
    const int* cfirst = a.col_first + (size_t)l * a.W0;
    const float* cw = a.col_w + (size_t)l * a.W0 * a.T;
    // the level's rows ya..yb and columns xa..xb of the tile + halo, and
    // their tap tables in shared memory
    const int ya = max(y0 - HALO, 0), yb = min(y0 + TY + HALO, h) - 1;
    const int xa = max(x0 - HALO, 0), xb = min(x0 + TX + HALO, w) - 1;
    const int nr = yb - ya + 1, nxc = xb - xa + 1;
    for (int i = tid; i < SH * SW; i += NT) {
        const int y = y0 - HALO + i / SW, x = x0 - HALO + i % SW;
        if (y < 0 || y >= h || x < 0 || x >= w) S[i / SW][i % SW] = 0.0f;
    }
    for (int k = tid; k < nr * (ty + 1); k += NT) {
        const int r = k / (ty + 1), c = k % (ty + 1), y = ya + r;
        if (c == 0) s_rf[r] = rfirst[y];
        else s_rw[r][c - 1] = rw[(size_t)y * a.T + c - 1];
    }
    for (int k = tid; k < nxc * (tx + 1); k += NT) {
        const int q = k / (tx + 1), c = k % (tx + 1), x = xa + q;
        if (c == 0) s_cf[q] = cfirst[x];
        else s_cw[q][c - 1] = cw[(size_t)x * a.T + c - 1];
    }
    __syncthreads();
    for (int cx = 0; cx < nxc;) {
        // this chunk's columns xa + cx .. xa + ce: those whose taps lie within
        // TCAP input columns of the first (col_first rises with x; the wrapper
        // checks the taps)
        const int X0 = min(s_cf[cx], a.W0 - 1);
        const int q = min(cx + tid, nxc - 1);
        const int fit = __syncthreads_count(tid < SW && cx + tid < nxc &&
                                            min(s_cf[q] + tx - 1, a.W0 - 1) - X0 < TCAP);
        const int ce = cx + fit - 1;
        const int nX = min(s_cf[ce] + tx - 1, a.W0 - 1) - X0 + 1;
        // row pass: T[r][X - X0] = sum_ky rw[ky] * img[min(fy + ky, H0 - 1), X];
        // a warp a row, a lane four columns 32 apart, each tap's four loads
        // issued together
        for (int r = warp; r < nr; r += NT / 32) {
            const int fy = s_rf[r];
            for (int xo = lane; xo < nX; xo += 128) {
                float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
                for (int ky = 0; ky < ty; ++ky) {
                    const float* src = a.img + (size_t)min(fy + ky, a.H0 - 1) * a.W0 + X0 + xo;
                    float p[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u) p[u] = xo + 32 * u < nX ? __ldg(src + 32 * u) : 0.0f;
#pragma unroll
                    for (int u = 0; u < 4; ++u) v[u] = v[u] + s_rw[r][ky] * p[u];
                }
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (xo + 32 * u < nX) T[r * TCAP + xo + 32 * u] = v[u];
            }
        }
        __syncthreads();
        // column pass: out(y, x) = sum_kx cw[kx] * T[r][min(fx + kx, W0 - 1) - X0]
        for (int r = warp; r < nr; r += NT / 32) {
            const float* row = T + r * TCAP - X0;
            for (int xq = cx + lane; xq <= ce; xq += 32) {
                const int fx = s_cf[xq];
                float acc = 0.0f;
                for (int kx = 0; kx < tx; ++kx) acc = acc + s_cw[xq][kx] * row[min(fx + kx, a.W0 - 1)];
                S[ya + r - (y0 - HALO)][xa + xq - (x0 - HALO)] = acc;
            }
        }
        __syncthreads();
        cx = ce + 1;
    }

    // FAST score of the tile + 1-pixel halo (thresholded); is_hi of the tile.
    // The compass pretest first at every position; those that pass go to
    // their warp's list, whose arcs then run 32 to a warp step (a warp whose
    // lanes mostly fail would otherwise run the arcs for the few)
    float* SC = T;                                   // [TY + 2][TX + 2]
    float* V = T + NPOS;                             // [TY][TX + 6]
    const float th = a.thr_lo;
    int nlist = 0;
    for (int base = warp * 32; base < NPOS; base += NT) {
        const int i = base + lane;
        const int sy = i / (TX + 2), sx = i % (TX + 2);
        const int y = y0 - 1 + sy, x = x0 - 1 + sx;
        unsigned pass = 0;
        if (i < NPOS && y >= 3 && y < h - 3 && x >= 3 && x < w - 3) {
            const int cy = sy + HALO - 1, cxs = sx + HALO - 1;
            const float c = S[cy][cxs];
            const float n = S[cy - 3][cxs] - c, e = S[cy][cxs + 3] - c;     // compass points 0, 4,
            const float so = S[cy + 3][cxs] - c, wd = S[cy][cxs - 3] - c;   // 8 and 12
            const bool bright = (n > th && e > th) || (e > th && so > th) || (so > th && wd > th) ||
                                (wd > th && n > th);
            const bool dark = (-n > th && -e > th) || (-e > th && -so > th) || (-so > th && -wd > th) ||
                              (-wd > th && -n > th);
            pass = (bright ? 1u : 0u) | (dark ? 2u : 0u);
        }
        if (i < NPOS && !pass) {
            SC[i] = 0.0f;
            const bool own = sy >= 1 && sy <= TY && sx >= 1 && sx <= TX;
            if (own && y < h && x < w) a.is_hi[plane + (size_t)y * a.W0 + x] = 0;
        }
        const unsigned m = __ballot_sync(0xffffffffu, pass != 0);
        if (pass) flist[warp][nlist + __popc(m & ((1u << lane) - 1u))] = (unsigned short)(i | (pass << 12));
        nlist += __popc(m);
    }
    __syncwarp();
    for (int e = lane; e < nlist; e += 32) {
        const unsigned code = flist[warp][e];
        const int i = code & 0xfff, sy = i / (TX + 2), sx = i % (TX + 2);
        const int y = y0 - 1 + sy, x = x0 - 1 + sx, cy = sy + HALO - 1, cxs = sx + HALO - 1;
        const float c = S[cy][cxs];
        float d[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) d[k] = S[cy + c_dy[k]][cxs + c_dx[k]] - c;
        // a polarity that fails the pretest is <= thr_lo: leaving it out
        // changes no output
        float v = (code & (1u << 12)) ? arc_bright(d) : -INFINITY;
        if (code & (2u << 12)) v = fmaxf(v, -arc_dark(d));
        SC[i] = v > a.thr_lo ? v : 0.0f;
        const bool own = sy >= 1 && sy <= TY && sx >= 1 && sx <= TX;
        if (own && y < h && x < w) a.is_hi[plane + (size_t)y * a.W0 + x] = v > a.thr_hi ? 1 : 0;
    }

    // blur, vertical pass: V[r][c] at row y0 + r and (pre-reflection) column x0 - 3 + c
    for (int i = tid; i < TY * (TX + 6); i += NT) {
        const int r = i / (TX + 6), c = i % (TX + 6);
        const int y = y0 + r, q = reflect101(x0 - 3 + c, w);
        float acc = 0.0f;
        // columns that no in-level pixel of the tile reads may reflect out of the halo
        if (y < h && q >= x0 - HALO && q < x0 + TX + HALO) {
            const int sx = q - x0 + HALO;
            acc = a.k[0] * S[reflect101(y - 3, h) - y0 + HALO][sx];
            for (int k = 1; k < 7; ++k) acc = acc + a.k[k] * S[reflect101(y - 3 + k, h) - y0 + HALO][sx];
        }
        V[i] = acc;
    }
    __syncthreads();

    for (int i = tid; i < TY * TX; i += NT) {
        const int r = i / TX, c = i % TX, y = y0 + r, x = x0 + c;
        if (y >= h || x >= w) continue;
        const size_t o = plane + (size_t)y * a.W0 + x;
        a.pyr3[o] = S[r + HALO][c + HALO];
        const float* vr = V + r * (TX + 6) + c;
        float b = a.k[0] * vr[0];
        for (int k = 1; k < 7; ++k) b = b + a.k[k] * vr[k];
        a.blur[o] = b;
        const float* sr = SC + r * (TX + 2) + c;
        const float s0 = sr[(TX + 2) + 1];
        float m = s0;
        for (int dy = 0; dy < 3; ++dy)
            for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, sr[dy * (TX + 2) + dx]);
        const bool inside = y >= a.margin && y < h - a.margin && x >= a.margin && x < w - a.margin;
        a.score[o] = (inside && s0 >= m) ? s0 : 0.0f;
    }
}

extern "C" int fast_nms_launch(const PyrArgs* a, cudaStream_t stream) {
    const int items = a->seg[2 * a->n_levels];
    if (items > 0) pyramid_fast_nms<<<items, NT, 0, stream>>>(*a);
    return (int)cudaGetLastError();
}
