// Bit-packed Hamming: (a) the batched, gate-fused matcher, (b) each map
// point's distinctive descriptor.
//
// Replaces (JAX reference): ops/matching.py match_masked with the candidate
// masks of window_mask / octave_mask / search_for_triangulation, over
// ops/hamming.py hamming_pairwise + masked_min2 (a); the descriptor half of
// worldmap/map_state.py _stats_from_table (:386-405): the gather of each
// point's observed descriptors, their vmapped pairwise Hamming distances,
// the sort, the median and the argmin (b).
//
// Bound of (a): the descriptors (64 B each), the gate inputs (a few words a
// row or column) and the outputs are the bytes; 16 XOR + popcount + add per
// gated pair are the operations.  No [N1,N2] tensor is read or written: the
// gate (validity, circular window + octave band, or epipolar distance) is
// evaluated per pair in registers.  At the main path's shapes (1024-4096
// rows x 1024 columns, B = 1-20) both are a few microseconds or less, so
// launches and host work decide the time: the design makes one launch per
// call, however many problems the call batches.
//
// Design (a), one launch: grid (row blocks x column splits, B).  A CTA takes
// MNT = 256 rows of one problem, a warp 32 of them (lane i row i), and one
// split of at most CS_MAX columns (the wrapper's `cs`: 256, halved down to 64
// while the grid would fill fewer than two CTAs an SM of the H100's 132).
// The rows and the split's descriptors go to shared memory by cp.async (rows
// padded to 20 words, so the 16-byte and fragment loads below hit distinct
// banks), with each column's gate terms, popcount and validity; no load
// waits on a validity flag.  A lane keeps its row's gate terms and running
// (best, first index, second) in registers.  The warp walks the split in
// chunks of 32 columns:
//  - the gate first: lane i tests its row against the chunk's 32 columns
//    (their terms read as broadcasts), a bit a column; the epipolar test in a
//    branch-free pass, IEEE's division after it for the few quotients near
//    the threshold;
//  - a chunk that no lane gates is done;
//  - the gated pairs' distances: where no lane has more than POPC_MAX of
//    them, 16 XOR + __popc a pair from the staged rows; else 16
//    mma.sync.m16n8k256.b1.and.popc for the warp's 32 rows x the chunk's 32
//    columns (a b1 mma costs about what 8 pairs' popcounts do on this card),
//    through a per-warp shared buffer so that lane i reads row i's, and d =
//    popc(row) + popc(column) - 2 popc(row AND column), exact integers;
//  - each lane merges its gated columns, from the chunk's column i on (so
//    that where every pair is gated no two lanes update one column key at
//    once), by (distance, then index), and lowers the column's key (d << 22
//    | row) in shared memory with atomicMin.
// So a pair costs the gate's few operations; distances, merges and key
// updates follow the gated pairs.  The ungated columns of a split read
// MAX_DIST: they enter a row's state as one term (MAX_DIST, the split's
// first ungated column, MAX_DIST if there are two or more), counted, not
// walked.  The CTA then lowers the global column keys (one atomicMin a
// column it touched) and, where the row block has several splits, stores
// its rows' 8-byte records; the last split of the row block to arrive (an
// atomic ticket after __threadfence(), the threadFenceReduction pattern)
// merges the others' records into its registers (all loads issued first),
// applies the distance gate and the ratio test, writes the rows that fail
// them as unmatched and appends the rest to the problem's candidates (a
// warp's in one atomicAdd).  The last row block of the problem to arrive (a
// second ticket) checks the candidates alone against the final column keys
// (the column-min dedup or the mutual check), RPT a thread loaded ahead, and
// resets the problem's keys, count and tickets for the next call.  A
// cooperative launch with a grid-wide sync would need every CTA resident at
// once, which B = 20 problems are not.  The workspace (column keys, records,
// candidates, tickets) belongs to the device and is reused by every call on
// the stream.
//
// Bit for bit as the plain torch version (kernels/hamming.py): best is the
// first column on ties; second is the minimum over every other column
// (ties give second == best); ungated pairs read MAX_DIST = 512; the packed
// key gives the lowest row on ties.  Gate arithmetic is written in the plain
// version's order and compiled with --fmad=false, so a float compare decides
// the same bit in both.
//
// Bound of (b): bytes.  A point needs its max(cnt, 1) observed rows (64 B
// each, with their two indices), its count, and writes 68 bytes: at most
// ~2.4 KB, 9.7 MB at Q = 4096 with every count 32 (~3 us at 3.35 TB/s).
// The reference materialises the [Q,32,16] gather and the [Q,32,32]
// distances and sorts them; (b) keeps all of it on chip.
//
// Design (b), one warp a point, lane i for observation i: lane i loads row
// i straight from kf_desc through (obs_kf, obs_ft) into shared memory (rows
// padded to 20 words, so the fragment loads below hit 32 distinct banks)
// and counts its bits; the distances then reuse that buffer.  The 32 x 32
// AND-popcounts are 16 mma.sync.m16n8k256.b1.and.popc (2 row blocks x 4
// column blocks x 2 k-steps); d(i,j) = popc(i) + popc(j) - 2 popc(i AND j),
// and columns j >= cnt read 2048, as in the reference.  The distances go
// through shared memory so that lane i holds row i; it finds the element of
// rank k = (cnt-1)/2 of its first cnt distances bit by bit: the largest v
// below 1024 with at most k distances under v, 10 counts over the row
// (10 ceil(cnt/8) 8 compares; rows i >= cnt read 2048).  A warp minimum of
// med << 5 | i picks the first row of least median, as torch.argmin does
// (best = 0 when cnt = 0), and 16 lanes copy its row out (again from
// kf_desc, 64 bytes in L2).  Integer throughout: equal to the plain twin.

#include <cuda_runtime.h>
#include <stdint.h>

#define WORDS 16
#define MAX_DIST 512
#define NO_DIST (MAX_DIST + 1)                       // "no column yet"
#define MW 8                                         // warps a CTA, 32 rows each
#define MNT (MW * 32)                                // threads, and rows, a CTA
#define CS_MAX 256                                   // columns a split (a CTA's shared memory)
#define CSTR 20                                      // words a staged column: 16 + 4 of padding
#define TSTR 17                                      // words a row of a warp's AND-popcounts
#define ROW_BITS 22                                  // a row index in a column key
#define KEY_INIT ((unsigned)MAX_DIST << ROW_BITS)    // row 0 at MAX_DIST
#define AHEAD 16                                     // records a thread loads before it uses them
#define RPT 4                                        // candidates a thread of the finish loads ahead
#define POPC_MAX 6                                   // gated columns a lane may have in a chunk for popcounts

enum { GATE_NONE = 0, GATE_WINDOW = 1, GATE_EPIPOLAR = 2, GATE_MASK = 3 };

// Field order and types mirror kernels/hamming.py:_MatchArgs.  Batch strides
// are in elements; 0 means the array is shared by every problem.  A null
// validity pointer means "all valid".
struct MatchArgs {
    const int* d1; const int* d2; const uint8_t* rv; const uint8_t* cv;
    long long s_d1, s_d2, s_rv, s_cv;
    // window: proj_xy [N1,2], radius [N1] (or rad_scalar when null),
    // pred_octave [N1]; shared with the epipolar gate: xy2 [N2,2], octave2 [N2]
    const float* pxy; const float* rad; const int* poct; const float* xy2; const int* oct2;
    long long s_pxy, s_rad, s_poct, s_xy2, s_oct2;
    float rad_scalar; int lo, hi, use_oct;
    // epipolar: F12 [3,3], xy1 [N1,2], inv_sigma2 [levels]
    const float* F; const float* xy1; const float* isig2;
    long long s_F, s_xy1;
    // dense mask [N1,N2]
    const uint8_t* mask; long long s_mask;
    int B, N1, N2, gate, max_dist, mutual;
    float ratio;
    int cs;                       // columns a split: a multiple of 32, at most CS_MAX
    unsigned* colkey;             // [B,N2] d << ROW_BITS | row; KEY_INIT between calls
    int2* rowstate;               // [B,S+1,N1] a split's (best | second << 16, first index);
                                  // then the candidates (row | best << 22, first index)
    unsigned* ticket;             // [B,RB+2] a row block's splits, the problem's row blocks,
                                  // its candidates; 0 between calls
    int* idx; int* dist;          // [B,N1] each
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }

// merge (b, i, s) into (best, idx, second): lower distance, then lower index wins
__device__ __forceinline__ void merge(int& best, int& idx, int& second, int b, int i, int s) {
    if (b < best || (b == best && i < idx)) {
        second = min(s, best);
        best = b;
        idx = i;
    } else {
        second = min(second, b);
    }
}

// D = popc(A AND B) + C for a 16x256 (row) by 256x8 (col) bit tile
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a window pair's gate, in the plain version's order
__device__ __forceinline__ bool window_pass(const float4 t, float px, float py, float r2, bool oct,
                                            int olo, int ohi) {
    const float dx = px - t.x, dy = py - t.y;
    bool g = dx * dx + dy * dy <= r2;
    if (oct) {
        const int o2 = __float_as_int(t.z);
        g = g && o2 >= olo && o2 <= ohi;
    }
    return g;
}

// 32 gate bits of a lane's row against a chunk's columns `ct` (bit c: column c)
__device__ __forceinline__ unsigned window_bits(const float4* ct, float px, float py, float r2,
                                                bool oct, int olo, int ohi) {
    unsigned m = 0;
#pragma unroll
    for (int c = 0; c < 32; ++c) m |= (unsigned)window_pass(ct[c], px, py, r2, oct, olo, ohi) << c;
    return m;
}

// the epipolar test v^2 / den < thr without its division where the quotient,
// within three float32 roundings of v^2 x (1 / den), lies beyond 2^-20 of thr
// (the column's t.z, t.w): a branch-free pass over the 32 columns, then
// IEEE's division for the few near thr (or NaN)
__device__ __forceinline__ unsigned epipolar_bits(const float4* ct, const float* thr, float g0,
                                                  float g1, float g2, float den, float rden) {
    unsigned m = 0, near = 0;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
        const float4 t = ct[c];
        const float v = g0 * t.x + g1 * t.y + g2;
        const float qa = (v * v) * rden;
        m |= (unsigned)(qa < t.z) << c;
        near |= (unsigned)(!(qa < t.z) && !(qa > t.w)) << c;
    }
    while (near) {
        const int c = __ffs(near) - 1;
        near &= near - 1u;
        const float4 t = ct[c];
        const float v = g0 * t.x + g1 * t.y + g2;
        m |= (unsigned)((v * v) / den < thr[c]) << c;
    }
    return m;
}

// merge a gated pair (d, column j) into a lane's state, by distance and then index
__device__ __forceinline__ void take(int& best, int& bidx, int& second, int d, int j) {
    if (d < best || (d == best && j < bidx)) { second = best; best = d; bidx = j; }
    else second = min(second, d);
}

// the Hamming distance of a staged row and a staged column (16 popcounts)
__device__ __forceinline__ int popc_dist(const uint4* x, const uint4* y) {
    int d = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const uint4 u = x[p], v = y[p];
        d += __popc(u.x ^ v.x) + __popc(u.y ^ v.y) + __popc(u.z ^ v.z) + __popc(u.w ^ v.w);
    }
    return d;
}

// the kernel's dynamic shared memory, in bytes: rows and columns, the
// columns' terms, popcounts and keys, the per-warp AND-popcounts, the
// chunks' valid columns
#define SMEM_MATCH (2 * CS_MAX * CSTR * 4 + CS_MAX * (16 + 4 + 4 + 4) + MW * 32 * TSTR * 4 + CS_MAX / 8)

__global__ void __launch_bounds__(MNT, 3) hamming_match_fused(const MatchArgs a) {
    static_assert(MNT == CS_MAX, "a thread stages a row and a column");
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned* rdesc = reinterpret_cast<unsigned*>(smem);            // the CTA's rows [MNT][CSTR]
    unsigned* cdesc = rdesc + MNT * CSTR;                           // the split's columns [CS_MAX][CSTR]
    float4* cterm = reinterpret_cast<float4*>(cdesc + CS_MAX * CSTR);   // window: x2, y2, octave
                                        // (bits); epipolar: x2, y2, thr (1 - 2^-20), thr (1 + 2^-20)
    float* cthr = reinterpret_cast<float*>(cterm + CS_MAX);         // epipolar: thr
    int* cpop = reinterpret_cast<int*>(cthr + CS_MAX);              // popc(column)
    unsigned* ckey = reinterpret_cast<unsigned*>(cpop + CS_MAX);    // the CTA's column keys
    unsigned* tand = ckey + CS_MAX;                                 // a warp's popc(row AND column)
                                                                    // [MW][32 rows][TSTR]
    unsigned* cvalid = tand + MW * 32 * TSTR;                       // a chunk's valid columns
    __shared__ int is_last;

    const int N1 = a.N1, N2 = a.N2, S = (N2 + a.cs - 1) / a.cs, RB = gridDim.x / S;
    const int rb = blockIdx.x / S, split = blockIdx.x - rb * S, b = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g8 = lane >> 2, t4 = lane & 3;
    const int c0 = split * a.cs, ncols = min(a.cs, N2 - c0);
    const int r0 = rb * MNT, i = r0 + tid;         // the CTA's first row; this lane's row
    const bool window = a.gate == GATE_WINDOW, spatial = window || a.gate == GATE_EPIPOLAR;

    // (a) stage the CTA's rows and the split's columns by cp.async, and every
    // gate term (the loads issued together: none waits on a validity flag)
    {
        const int* d1 = a.d1 + (size_t)b * a.s_d1 + (size_t)r0 * WORDS;
        const int nrows = min(MNT, N1 - r0);
        if (((uintptr_t)d1 & 15) == 0) {
            for (int k = tid; k < nrows * 4; k += MNT)
                cp_async16(&rdesc[(k >> 2) * CSTR + 4 * (k & 3)], d1 + (size_t)k * 4);
        } else {                                    // desc1 need not be 16-byte aligned
            for (int k = tid; k < nrows * WORDS; k += MNT)
                rdesc[(k / WORDS) * CSTR + k % WORDS] = (unsigned)d1[k];
        }
        const int* d2 = a.d2 + (size_t)b * a.s_d2 + (size_t)c0 * WORDS;
        for (int k = tid; k < ncols * 4; k += MNT)
            cp_async16(&cdesc[(k >> 2) * CSTR + 4 * (k & 3)], d2 + (size_t)k * 4);
        cp_async_commit();
        const int t = tid, j = c0 + t;
        const bool has = t < ncols;
        bool cok = has;
        if (has && a.cv) cok = a.cv[(size_t)b * a.s_cv + j] != 0;
        float4 ct = make_float4(0.f, 0.f, -INFINITY, -INFINITY);
        float thr = 0.f;
        if (has && spatial) {
            const float* p = a.xy2 + (size_t)b * a.s_xy2 + (size_t)j * 2;
            ct.x = p[0];
            ct.y = p[1];
            if (window) {
                ct.z = __int_as_float(a.use_oct ? a.oct2[(size_t)b * a.s_oct2 + j] : 0);
            } else {
                thr = 3.84f * (1.0f / a.isig2[a.oct2[(size_t)b * a.s_oct2 + j]]);
                const bool fast = thr > 1e-30f;
                ct.z = fast ? thr * (1.0f - 0x1p-20f) : -INFINITY;
                ct.w = fast ? thr * (1.0f + 0x1p-20f) : INFINITY;
            }
        }
        cterm[t] = ct;
        cthr[t] = thr;
        ckey[t] = KEY_INIT;
        const unsigned vm = __ballot_sync(0xffffffffu, cok);
        if (lane == 0) cvalid[warp] = vm;
    }
    // this lane's row: validity and gate terms
    const bool inrow = i < N1;
    bool rok = inrow;
    if (inrow && a.rv) rok = a.rv[(size_t)b * a.s_rv + i] != 0;
    float g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 1.f, rden = 1.f;   // window: px, py, r * r
    int olo = 0, ohi = 0;
    const uint8_t* mrow = nullptr;
    if (inrow && window) {
        const float* p = a.pxy + (size_t)b * a.s_pxy + (size_t)i * 2;
        const float r_ = a.rad ? a.rad[(size_t)b * a.s_rad + i] : a.rad_scalar;
        g0 = p[0];
        g1 = p[1];
        g2 = r_ * r_;
        if (a.use_oct) {
            const int po = a.poct[(size_t)b * a.s_poct + i];
            olo = po + a.lo;
            ohi = po + a.hi;
        }
    } else if (inrow && a.gate == GATE_EPIPOLAR) {
        const float* F = a.F + (size_t)b * a.s_F;
        const float* p = a.xy1 + (size_t)b * a.s_xy1 + (size_t)i * 2;
        const float x = p[0], y = p[1];
        g0 = x * F[0] + y * F[3] + F[6];           // [x, y, 1] @ F12, term by term
        g1 = x * F[1] + y * F[4] + F[7];
        g2 = x * F[2] + y * F[5] + F[8];
        g3 = fmaxf(g0 * g0 + g1 * g1, 1e-12f);
        rden = __frcp_rn(g3);
    } else if (inrow && a.gate == GATE_MASK) {
        mrow = a.mask + (size_t)b * a.s_mask + (size_t)i * N2 + c0;
    }
    cp_async_wait0();
    __syncthreads();
    const uint4* myrow = reinterpret_cast<const uint4*>(&rdesc[tid * CSTR]);
    int pr = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const uint4 v = myrow[p];
        pr += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
    if (tid < ncols) {
        const uint4* col = reinterpret_cast<const uint4*>(&cdesc[tid * CSTR]);
        int pc = 0;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const uint4 v = col[p];
            pc += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        }
        cpop[tid] = pc;
    }
    __syncthreads();

    // (b) the walk: a warp's rows against 32 columns at a time, each chunk's
    // gate bits, then its gated pairs
    int best = NO_DIST, bidx = 0x7fffffff, second = NO_DIST;
    int ngated = 0, u = -1;                       // gated columns; the first ungated one
    const bool wany = __any_sync(0xffffffffu, rok);
    const int nchunks = (ncols + 31) >> 5;
    unsigned* tw = tand + warp * 32 * TSTR;
    for (int k = 0; k < nchunks; ++k) {
        const int cb = 32 * k;
        const unsigned exist = ncols - cb >= 32 ? 0xffffffffu : (1u << (ncols - cb)) - 1u;
        unsigned m = 0;
        if (wany) {
            if (window) {
                if (rok) m = window_bits(cterm + cb, g0, g1, g2, a.use_oct, olo, ohi);
            } else if (a.gate == GATE_EPIPOLAR) {
                if (rok) m = epipolar_bits(cterm + cb, cthr + cb, g0, g1, g2, g3, rden);
            } else if (a.gate == GATE_MASK) {
                if (rok)
                    for (int c = 0; c < 32 && cb + c < ncols; ++c) m |= (unsigned)(mrow[cb + c] != 0) << c;
            } else {
                m = rok ? 0xffffffffu : 0u;
            }
            m &= cvalid[k];
        }
        ngated += __popc(m);
        if (u < 0 && (exist & ~m)) u = c0 + cb + __ffs(exist & ~m) - 1;
        // the most gated columns a lane has here: few, each pair's 16
        // popcounts; more, the chunk's popc(row AND column) on the tensor cores
        const int most = __reduce_max_sync(0xffffffffu, __popc(m));
        if (most == 0) continue;
        const bool tc = most > POPC_MAX;
        if (tc) {
            int acc[2][4][4];
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
#pragma unroll
                for (int nb = 0; nb < 4; ++nb)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0;
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                // A: lane (g, t) holds words t and t + 4 of this k-step of
                // rows g and g + 8 of each 16-row block
                unsigned af[2][4];
#pragma unroll
                for (int mb = 0; mb < 2; ++mb) {
                    const unsigned* lo = &rdesc[(warp * 32 + 16 * mb + g8) * CSTR + 8 * s + t4];
                    af[mb][0] = lo[0]; af[mb][1] = lo[8 * CSTR]; af[mb][2] = lo[4]; af[mb][3] = lo[8 * CSTR + 4];
                }
#pragma unroll
                for (int nb = 0; nb < 4; ++nb) {
                    const unsigned* col = &cdesc[(cb + 8 * nb + g8) * CSTR + 8 * s + t4];
#pragma unroll
                    for (int mb = 0; mb < 2; ++mb) mma_and_popc(acc[mb][nb], af[mb], col[0], col[4]);
                }
            }
            __syncwarp();                       // the previous chunk's reads are done
#pragma unroll
            for (int mb = 0; mb < 2; ++mb)
#pragma unroll
                for (int nb = 0; nb < 4; ++nb) {
                    const int r = 16 * mb + g8, cp = 4 * nb + t4;
                    tw[r * TSTR + cp] = (unsigned)acc[mb][nb][0] | ((unsigned)acc[mb][nb][1] << 16);
                    tw[(r + 8) * TSTR + cp] = (unsigned)acc[mb][nb][2] | ((unsigned)acc[mb][nb][3] << 16);
                }
            __syncwarp();
        }
        // this lane's gated columns from column `lane` of the chunk on (no
        // two lanes on one column key at once where every pair is gated)
        unsigned mr = __funnelshift_r(m, m, lane);
        while (mr) {
            const int c = (__ffs(mr) - 1 + lane) & 31;
            mr &= mr - 1u;
            int d;
            if (tc) {
                const unsigned w = tw[lane * TSTR + (c >> 1)];
                d = pr + cpop[cb + c] - 2 * (int)((w >> (16 * (c & 1))) & 0xffffu);
            } else {
                d = popc_dist(myrow, reinterpret_cast<const uint4*>(&cdesc[(cb + c) * CSTR]));
            }
            take(best, bidx, second, d, c0 + cb + c);
            atomicMin(&ckey[cb + c], ((unsigned)d << ROW_BITS) | (unsigned)i);
        }
    }
    // the split's ungated columns, each at MAX_DIST
    const int nun = ncols - ngated;
    if (nun > 0) merge(best, bidx, second, MAX_DIST, u, nun >= 2 ? MAX_DIST : NO_DIST);

    // (c) the column keys this CTA lowered; the split's row records
    __syncthreads();
    if (tid < ncols && ckey[tid] < KEY_INIT) atomicMin(&a.colkey[(size_t)b * N2 + c0 + tid], ckey[tid]);
    int2* recs = a.rowstate + (size_t)b * (S + 1) * N1;    // [S + 1][N1]: the splits', candidates
    if (S > 1 && inrow) recs[(size_t)split * N1 + i] = make_int2(best | (second << 16), bidx);

    // (d) the last split of the row block merges the others' records
    unsigned* tk = a.ticket + (size_t)b * (RB + 2);       // row blocks', the problem's, candidates
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = S == 1 || atomicAdd(&tk[rb], 1u) == (unsigned)(S - 1);
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (S > 1 && inrow) {
        for (int s0 = 0; s0 < S; s0 += AHEAD) {
            int2 r[AHEAD];
#pragma unroll
            for (int k = 0; k < AHEAD; ++k) {
                const int s = s0 + k;
                r[k] = s < S && s != split ? __ldcg(recs + (size_t)s * N1 + i)
                                           : make_int2(NO_DIST | (NO_DIST << 16), 0x7fffffff);
            }
#pragma unroll
            for (int k = 0; k < AHEAD; ++k) merge(best, bidx, second, r[k].x & 0xffff, r[k].y, r[k].x >> 16);
        }
    }
    // the distance gate and the ratio test (the plain version's second:
    // MAX_DIST where no other column is); a row that fails is unmatched now,
    // one that passes joins the problem's candidates
    int* idx_out = a.idx + (size_t)b * N1;
    int* dist_out = a.dist + (size_t)b * N1;
    const bool cand = inrow && best <= a.max_dist && (float)best < a.ratio * (float)min(second, MAX_DIST);
    if (inrow && !cand) {
        idx_out[i] = -1;
        dist_out[i] = MAX_DIST;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, cand);
    unsigned at = 0;
    if (lane == 0 && bal) at = atomicAdd(&tk[RB + 1], (unsigned)__popc(bal));
    at = __shfl_sync(0xffffffffu, at, 0);
    int2* cands = recs + (size_t)S * N1;
    if (cand) cands[at + __popc(bal & ((1u << lane) - 1u))] =
        make_int2((int)((unsigned)i | ((unsigned)best << ROW_BITS)), bidx);

    // (e) the last row block of the problem checks the candidates against the
    // final column keys: the column-min dedup or the mutual check
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        if (S > 1) tk[rb] = 0u;
        is_last = atomicAdd(&tk[RB], 1u) == (unsigned)(RB - 1);
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const unsigned* keys = a.colkey + (size_t)b * N2;
    const int n = (int)__ldcg(&tk[RB + 1]);
    for (int base = 0; base < n; base += RPT * MNT) {
        int2 e[RPT];
        unsigned key[RPT];
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
            const int q = base + k * MNT + tid;
            e[k] = q < n ? __ldcg(cands + q) : make_int2(0, -1);
        }
#pragma unroll
        for (int k = 0; k < RPT; ++k) key[k] = e[k].y >= 0 ? __ldcg(keys + e[k].y) : KEY_INIT;
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
            if (e[k].y < 0) continue;
            const int r = (int)((unsigned)e[k].x & ((1u << ROW_BITS) - 1u));
            const int bb = (int)((unsigned)e[k].x >> ROW_BITS);
            const bool m = a.mutual ? (int)(key[k] & ((1u << ROW_BITS) - 1u)) == r
                                    : bb <= (int)(key[k] >> ROW_BITS);
            idx_out[r] = m ? e[k].y : -1;
            dist_out[r] = m ? bb : MAX_DIST;
        }
    }
    // (f) reset the problem's column keys, count and ticket
    __syncthreads();
    for (int j = tid; j < N2; j += MNT) a.colkey[(size_t)b * N2 + j] = KEY_INIT;
    if (tid == 0) {
        tk[RB] = 0u;
        tk[RB + 1] = 0u;
    }
}

#define DD_WARPS 4
#define DD_NT (DD_WARPS * 32)
#define MAX_OBS 32
#define ROW_WORDS 20      // a staged row: 16 words + 4 of padding
#define DIST_STRIDE 36    // a row of distances: 32 + 4 of padding; the rows, then
                          // the distances, share one buffer of 32 x 36 words
#define BIG 2048          // the reference's sentinel, > any distance
#define MED_BITS 10       // distances are 0..512 < 2^10

__global__ void __launch_bounds__(DD_NT) distinctive_descriptors_kernel(
    const int* __restrict__ kf_desc, int K, int N, const int* __restrict__ obs_kf,
    const int* __restrict__ obs_ft, const int* __restrict__ obs_cnt, int Q,
    int* __restrict__ out_desc, int* __restrict__ out_best) {
    __shared__ __align__(16) int buf[DD_WARPS][MAX_OBS * DIST_STRIDE];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int q = blockIdx.x * DD_WARPS + warp;
    if (q >= Q) return;                                  // the whole warp
    unsigned* rw = reinterpret_cast<unsigned*>(buf[warp]);
    int* dw = buf[warp];
    const int cnt = min(max(obs_cnt[q], 0), MAX_OBS);

    // stage row `lane` (indices clamped, as the reference's gather clamps)
    const int kf = min(max(obs_kf[(size_t)q * MAX_OBS + lane], 0), K - 1);
    const int ft = min(max(obs_ft[(size_t)q * MAX_OBS + lane], 0), N - 1);
    const size_t row = (size_t)kf * N + ft;
    const int4* src = reinterpret_cast<const int4*>(kf_desc + row * WORDS);
    int pc = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
        const int4 v = __ldg(src + p);
        reinterpret_cast<int4*>(rw + lane * ROW_WORDS)[p] = v;
        pc += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
    __syncwarp();

    // popc(i AND j) for all 32 x 32 pairs: lane (g, t) of each fragment
    // holds words t and t+4 of a row (A) or column (B) per 8-word k-step
    const int g = lane >> 2, t = lane & 3;
    int acc[2][4][4];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mb][nb][e] = 0;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int w = 8 * s + t;
        unsigned a[2][4], b[4][2];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
            const unsigned* lo = rw + (16 * mb + g) * ROW_WORDS;
            const unsigned* hi = lo + 8 * ROW_WORDS;
            a[mb][0] = lo[w]; a[mb][1] = hi[w]; a[mb][2] = lo[w + 4]; a[mb][3] = hi[w + 4];
        }
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
            const unsigned* col = rw + (8 * nb + g) * ROW_WORDS;
            b[nb][0] = col[w];
            b[nb][1] = col[w + 4];
        }
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) mma_and_popc(acc[mb][nb], a[mb], b[nb][0], b[nb][1]);
    }
    __syncwarp();   // every fragment is read: the distances overwrite the rows
    // d = popc(i) + popc(j) - 2 popc(i AND j); lane (g, t) holds rows g, g+8
    // of each row block and columns 2t, 2t+1 of each column block
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = 16 * mb + g + 8 * h;
            const int pr = __shfl_sync(0xffffffffu, pc, r);
#pragma unroll
            for (int nb = 0; nb < 4; ++nb) {
                const int c0 = 8 * nb + 2 * t;
                const int p0 = __shfl_sync(0xffffffffu, pc, c0);
                const int p1 = __shfl_sync(0xffffffffu, pc, c0 + 1);
                int2 d;
                d.x = c0 < cnt ? pr + p0 - 2 * acc[mb][nb][2 * h] : BIG;
                d.y = c0 + 1 < cnt ? pr + p1 - 2 * acc[mb][nb][2 * h + 1] : BIG;
                *reinterpret_cast<int2*>(dw + r * DIST_STRIDE + c0) = d;
            }
        }
    __syncwarp();

    // lane i: the element of rank k = (cnt-1)/2 of row i's first cnt
    // distances, the largest v with at most k of them below v, built from
    // the high bit down; each step counts in blocks of 8 up to cnt (cnt is
    // the same on every lane, and columns past cnt hold BIG, never below v)
    int med = BIG;
    if (lane < cnt) {
        int d[MAX_OBS];
#pragma unroll
        for (int p = 0; p < MAX_OBS / 4; ++p) {
            const int4 v = reinterpret_cast<const int4*>(dw + lane * DIST_STRIDE)[p];
            d[4 * p] = v.x; d[4 * p + 1] = v.y; d[4 * p + 2] = v.z; d[4 * p + 3] = v.w;
        }
        const int k = (cnt - 1) >> 1;
        int v = 0;
#pragma unroll
        for (int b = MED_BITS - 1; b >= 0; --b) {
            const int trial = v + (1 << b);
            int below = 0;
#pragma unroll
            for (int l0 = 0; l0 < MAX_OBS; l0 += 8) {
                if (l0 < cnt) {
#pragma unroll
                    for (int l = l0; l < l0 + 8; ++l) below += d[l] < trial;
                }
            }
            if (below <= k) v = trial;
        }
        med = v;
    }
    const int bkey = __reduce_min_sync(0xffffffffu, (med << 5) | lane);
    const int bi = bkey & 31;
    const size_t brow = __shfl_sync(0xffffffffu, row, bi);
    if (lane < WORDS) out_desc[(size_t)q * WORDS + lane] = __ldg(kf_desc + brow * WORDS + lane);
    if (lane == 0) out_best[q] = bi;
}

extern "C" int hamming_match_launch(const MatchArgs* a, cudaStream_t stream) {
    if (a->B == 0 || a->N1 == 0) return (int)cudaGetLastError();
    if (a->cs <= 0 || a->cs > CS_MAX || a->cs % 32) return (int)cudaErrorInvalidValue;
    const int S = (a->N2 + a->cs - 1) / a->cs, RB = (a->N1 + MNT - 1) / MNT;
    static bool attr = false;
    if (!attr) {
        const cudaError_t e = cudaFuncSetAttribute(hamming_match_fused,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MATCH);
        if (e != cudaSuccess) return (int)e;
        attr = true;
    }
    hamming_match_fused<<<dim3(RB * S, a->B), MNT, SMEM_MATCH, stream>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int distinctive_descriptors_launch(const int* kf_desc, int K, int N, const int* obs_kf,
                                              const int* obs_ft, const int* obs_cnt, int Q,
                                              int* out_desc, int* out_best, cudaStream_t stream) {
    if (Q > 0)
        distinctive_descriptors_kernel<<<(Q + DD_WARPS - 1) / DD_WARPS, DD_NT, 0, stream>>>(
            kf_desc, K, N, obs_kf, obs_ft, obs_cnt, Q, out_desc, out_best);
    return (int)cudaGetLastError();
}
