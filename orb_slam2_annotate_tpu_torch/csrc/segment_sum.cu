// Kernel 11: a segment sum in one fixed order.
//
//   out[s, :] = sum over rows e with idx[e] == s, in ascending e, from +0.0,
//               of vals[e, :]
//
// Replaces no Pallas kernel: it replaces the scatter-adds that XLA lowers
// in order on the reference's TPU, which the port's solvers wrote as
// torch's index_add / index_put_(accumulate=True).  On the card those are
// float atomics, whose order of addition changes from run to run, so a
// loop closure's pose graph and global BA gave other bits on every run.
// Call sites: solvers/pose_graph.py (g, the D blocks and the PCG product
// over the K keyframes, H over the K x K blocks), solvers/ba_cg.py (Hcc,
// gc over the cameras; Hpp, gp over the points; the two sums of each PCG
// product) and solvers/ba_core.py build_normal_eqs (Hcc, Hpp, gc, gp and B
// over the P x C point-camera pairs).
//
// The plan (kernels/segment_sum.py segment_plan, built once a solve on the
// card): perm [E] int32, the rows in ascending (segment, row) order from a
// stable sort of the index, rows outside [0, S) last; offsets [S + 1]
// int32, segment s's rows are perm[offsets[s] .. offsets[s + 1]); G, the
// tile width (tile t is segments t G .. t G + G - 1: about 4 tiles an SM).
// The wrapper picks the path from E, S and D, which the host knows: R = 0
// for the walk, else the tiles' R rows a stage.
//
// Bound: bytes (each kept row read once with its index, each output row
// written once with its offset), or the longest segment's chain of
// dependent adds, whichever is longer.
//
// Design.  The walk (short segments, at most 32 rows a segment on average
// and an output of at most 4 M floats: the points' sums, the keyframes'
// and the pose graph's H): one thread a (segment, column) chain in flat
// order, so a warp packs 32 / D segments and its loads and its store
// coalesce; it reads its offsets, then eight rows' indices, then their
// values, before the adds: three dependent loads, no barrier.
//
// The tiles (long segments, a camera's hundreds of rows; or an output of
// many more segments than rows, mostly zeros, as B): one wave of CTAs,
// each walking tiles blockIdx.x, + gridDim.x, ...  A CTA copies its tile's
// offsets into shared memory with cp.async and, while they are in flight,
// writes +0.0 over the tile's whole output in 16-byte stores.  Then all its
// threads copy the tile's rows in stages of R rows into a ring of NS
// stages with cp.async, row by row coalesced (16-byte copies where a row
// is a multiple of 16 bytes, 8 or 4 otherwise), NS - 1 stages ahead, the
// stage's indices copied NS stages ahead of its rows, so no copy waits on
// a dependent load.  In a stage, a thread takes a (segment, column) chain
// of the segments that stage touches, in flat order (consecutive chains
// store consecutively), and adds that segment's rows of the stage in
// ascending order from shared memory, eight loads ahead of the adds; where
// the stage holds fewer rows than half its segments, the segments with
// rows are listed first (a ballot compaction), so the empty ones, which
// keep their zeros, cost no chain.  A segment that goes on into the next
// stage hands its partial sums over in a carry row (double-buffered).
//
// Either way each chain is one serial walk in ascending row from +0.0:
// the order of the CPU's serial index_add (kernels/segment_sum.py
// segment_sum_plain), bit for bit.  Built with --fmad=false like the
// others (only adds here).

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256        // threads a CTA
#define NS 3          // stages in the ring (NS - 1 in flight while one is added)

// The plan's device arrays and sizes, held on the host by the plan (one
// ctypes struct a plan, so a call passes one pointer for all of them).
struct SegPlan {
    const int* perm;
    const int* offsets;
    long long S;       // segments
    int G;             // tile width: segments a tile
};

template <int UB>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(UB)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// first tile-local segment not finished before row a (its end is past a,
// or it is empty at a or later): soff[0 .. n] are the tile's offsets
__device__ __forceinline__ int first_open(const int* soff, int n, int a) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int m = (lo + hi) >> 1;
        if (soff[m + 1] > a || soff[m] >= a) hi = m; else lo = m + 1;
    }
    return lo;
}

// first tile-local segment that starts at row b or later
__device__ __forceinline__ int first_from(const int* soff, int n, int b) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int m = (lo + hi) >> 1;
        if (soff[m] >= b) hi = m; else lo = m + 1;
    }
    return lo;
}

// acc + x[0] + x[D] + ... + x[(n - 1) D], one dependent add a row in that
// order; the loads of the next 8 rows are issued before the adds of these
// 8, so the chain waits on the adds alone
__device__ __forceinline__ float add_rows(float acc, const float* x, int n, int D) {
    if (n >= 8) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = x[i * D];
        x += 8 * D;
        n -= 8;
        while (n >= 8) {
            float w[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) w[i] = x[i * D];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, v[i]);
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = w[i];
            x += 8 * D;
            n -= 8;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, v[i]);
    }
    for (; n > 0; --n, x += D) acc = __fadd_rn(acc, *x);
    return acc;
}

// +0.0 over out[0 .. n), 16-byte stores between a scalar head and tail
__device__ __forceinline__ void zero_fill(float* out, long long n, int tid) {
    const int head = (int)min((long long)((16 - ((uintptr_t)out & 15)) & 15) / 4, n);
    if (tid < head) out[tid] = 0.f;
    float4* body = reinterpret_cast<float4*>(out + head);
    const long long nv = (n - head) / 4;
    for (long long i = tid; i < nv; i += NT) body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const long long tail = head + nv * 4 + tid;
    if (tail < n) out[tail] = 0.f;
}

// The walk: a thread a (segment, column) chain, the segment's rows eight
// at a time (their indices, then their values, loaded before the adds).
__global__ void __launch_bounds__(NT) segment_walk_kernel(
    const float* __restrict__ vals, const int* __restrict__ perm,
    const int* __restrict__ offsets, float* __restrict__ out, long long n, int D) {
    const long long q = (long long)blockIdx.x * NT + threadIdx.x;
    if (q >= n) return;
    const long long s = q / D;
    const int c = (int)(q - s * D);
    const int b = offsets[s], e = offsets[s + 1];
    float acc = 0.f;
    for (int i = b; i < e; i += 8) {
        int p[8];
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = i + k < e ? perm[i + k] : 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = i + k < e ? vals[(size_t)p[k] * D + c] : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k)
            if (i + k < e) acc = __fadd_rn(acc, v[k]);
    }
    out[q] = acc;
}

// UB: bytes a copy (16, 8 or 4, dividing 4 D and vals' address); R rows a stage
template <int UB>
__global__ void __launch_bounds__(NT) segment_sum_kernel(
    const float* __restrict__ vals, const int* __restrict__ perm,
    const int* __restrict__ offsets, float* __restrict__ out, long long S, int G, int D, int R) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* srows = reinterpret_cast<float*>(smem);          // [NS][R * D]
    float* carry = srows + (size_t)NS * R * D;              // [2][D]
    int* sperm = reinterpret_cast<int*>(carry + 2 * D);     // [2 NS][R]
    int* scount = sperm + 2 * NS * R;                       // [NT / 32]
    int* soff = scount + NT / 32;                           // [G + 1]
    int* slist = soff + G + 1;                              // [G]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int U = D * 4 / UB;                               // copies a row
    const char* vbytes = reinterpret_cast<const char*>(vals);
    const long long ntiles = (S + G - 1) / G;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const long long s0 = t * G;
        const int nseg = (int)min((long long)G, S - s0);
        for (int i = tid; i <= nseg; i += NT) cp_async<4>(soff + i, offsets + s0 + i);
        cp_commit();
        zero_fill(out + (size_t)s0 * D, (long long)nseg * D, tid);
        cp_wait<0>();
        __syncthreads();
        const int r0 = soff[0], r1 = soff[nseg], rows = r1 - r0;
        const int nst = rows > 0 ? (rows + R - 1) / R : 1;

        // the indices of stage k into their slot
        auto issue_perm = [&](int k) {
            if (k >= nst) return;
            const int a = r0 + k * R, n = min(R, r1 - a);
            int* dst = sperm + (k % (2 * NS)) * R;
            for (int i = tid; i < n; i += NT) cp_async<4>(dst + i, perm + a + i);
        };
        // the rows of stage k (its indices landed) into its row slot
        auto issue_rows = [&](int k) {
            if (k >= nst) return;
            const int n = min(R, r1 - (r0 + k * R));
            const int* p = sperm + (k % (2 * NS)) * R;
            char* dst = reinterpret_cast<char*>(srows + (size_t)(k % NS) * R * D);
            const int di = NT / U, du = NT % U;
            int i = tid / U, u = tid % U;
            while (i < n) {
                cp_async<UB>(dst + (size_t)i * D * 4 + u * UB,
                             vbytes + (size_t)p[i] * D * 4 + (size_t)u * UB);
                i += di;
                u += du;
                if (u >= U) { u -= U; ++i; }
            }
        };

        for (int k = 0; k < NS; ++k) issue_perm(k);
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        for (int k = 0; k < NS - 1; ++k) {
            issue_rows(k);
            issue_perm(k + NS);
            cp_commit();
        }
        for (int k = 0; k < nst; ++k) {
            cp_wait<NS - 2>();                              // stage k and indices k + NS - 1 landed
            __syncthreads();                                // stage k - 1 is added
            issue_rows(k + NS - 1);
            issue_perm(k + 2 * NS - 1);
            cp_commit();
            const int a = r0 + k * R, b = min(a + R, r1);
            const int lo = k == 0 ? 0 : first_open(soff, nseg, a);
            const int hi = k == nst - 1 ? nseg : first_from(soff, nseg, b);
            // the segments to walk: all of lo .. hi - 1, or, where they are
            // mostly empty, the list of those with rows in this stage, in order
            const bool sparse = 2 * (b - a) < hi - lo;
            int nlist = hi - lo;
            if (sparse) {
                nlist = 0;
                for (int i0 = lo; i0 < hi; i0 += NT) {
                    const int i = i0 + tid;
                    const bool has = i < hi && soff[i] < soff[i + 1];
                    const unsigned m = __ballot_sync(0xffffffffu, has);
                    if (lane == 0) scount[warp] = __popc(m);
                    __syncthreads();
                    int before = nlist, total = 0;
                    for (int w = 0; w < NT / 32; ++w) {
                        before += w < warp ? scount[w] : 0;
                        total += scount[w];
                    }
                    if (has) slist[before + __popc(m & ((1u << lane) - 1))] = i;
                    nlist += total;
                    __syncthreads();
                }
            }
            const float* sr = srows + (size_t)(k % NS) * R * D;
            const float* cin = carry + (k & 1) * D;
            float* cout = carry + ((k + 1) & 1) * D;
            const int dl = NT / D, dc = NT % D;
            int l = tid / D, c = tid % D;
            for (int q = tid; q < nlist * D; q += NT) {
                const int s = sparse ? slist[l] : lo + l;
                const int beg = soff[s], end = soff[s + 1];
                if (beg < end) {                            // an empty segment keeps its zeros
                    const int j = max(beg, a);
                    float acc = beg < a ? cin[c] : 0.f;
                    acc = add_rows(acc, sr + (size_t)(j - a) * D + c, min(end, b) - j, D);
                    if (end <= b) out[(size_t)(s0 + s) * D + c] = acc;
                    else cout[c] = acc;                     // the segment goes on into stage k + 1
                }
                l += dl;
                c += dc;
                if (c >= D) { c -= D; ++l; }
            }
        }
        cp_wait<0>();
        __syncthreads();                                    // before the next tile's copies
    }
}

template <int UB>
static int launch(const SegPlan* p, const float* vals, float* out, int D, int R,
                  cudaStream_t stream) {
    const size_t smem = (size_t)NS * R * D * 4 + 2 * (size_t)D * 4 + 2 * NS * (size_t)R * 4 +
                        (NT / 32) * 4 + (2 * (size_t)p->G + 1) * 4;
    // the kernel's attribute, and its CTAs a card at each shared memory size
    // seen (a solve calls with a few widths), kept from call to call
    static size_t allowed = 48 * 1024, seen_smem[8];
    static int seen_resident[8], n_seen = 0, next = 0;
    cudaError_t e;
    if (smem > allowed) {
        e = cudaFuncSetAttribute(segment_sum_kernel<UB>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        allowed = smem;
    }
    int resident = 0;
    for (int i = 0; i < n_seen; ++i)
        if (seen_smem[i] == smem) resident = seen_resident[i];
    if (resident == 0) {
        int dev, sms, per_sm;
        if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
            (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_sum_kernel<UB>,
                                                                NT, smem)) != cudaSuccess)
            return (int)e;
        resident = sms * (per_sm > 0 ? per_sm : 1);
        seen_smem[next] = smem;
        seen_resident[next] = resident;
        next = (next + 1) % 8;
        n_seen = n_seen < 8 ? n_seen + 1 : 8;
    }
    const long long ntiles = (p->S + p->G - 1) / p->G;
    const long long grid = ntiles < resident ? ntiles : resident;
    segment_sum_kernel<UB><<<(unsigned)grid, NT, smem, stream>>>(vals, p->perm, p->offsets, out,
                                                                 p->S, p->G, D, R);
    return (int)cudaGetLastError();
}

// out [S, D] from vals [E, D] in the plan's order: R rows a stage of the
// tiles (kernels/segment_sum.py stage_rows), or R = 0 for the walk.  The
// caller launches only for S and D above 0.
extern "C" int segment_sum_launch(const SegPlan* p, const float* vals, float* out, int D, int R,
                                  cudaStream_t stream) {
    if (R == 0) {                                           // the plan walks (short segments)
        const long long n = p->S * D;
        segment_walk_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(vals, p->perm,
                                                                             p->offsets, out, n, D);
        return (int)cudaGetLastError();
    }
    const uintptr_t base = (uintptr_t)vals;                // a view may start off 16 bytes
    if ((D * 4) % 16 == 0 && base % 16 == 0) return launch<16>(p, vals, out, D, R, stream);
    if ((D * 4) % 8 == 0 && base % 8 == 0) return launch<8>(p, vals, out, D, R, stream);
    return launch<4>(p, vals, out, D, R, stream);
}

// The card's time for one dependent float add (ns), for chip_smoke.py's
// chain floor: one thread, n dependent __fadd_rn, timed by %globaltimer
// and clock64 (out: [0] ns, [1] cycles, [2] the sum, kept live).
__global__ void fadd_chain_probe_kernel(long long* out, float x, int n) {
    float acc = 0.f;
    const long long c0 = clock64();
    unsigned long long t0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
#pragma unroll 16
    for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, x);
    unsigned long long t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    const long long c1 = clock64();
    out[0] = (long long)(t1 - t0);
    out[1] = c1 - c0;
    out[2] = (long long)__float_as_int(acc);
}

extern "C" int fadd_chain_probe(long long* out, float x, int n, cudaStream_t stream) {
    fadd_chain_probe_kernel<<<1, 1, 0, stream>>>(out, x, n);
    return (int)cudaGetLastError();
}
