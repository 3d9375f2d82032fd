// Fold over content-sorted match candidates, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel brotli_tpu/ops/fold_pallas.py:_make_kernel
// (launched by fold_sorted_pallas).  For every row i of the sorted operands
// [keys..., pos, payloads...] it scans the neighbours at sorted index i - j,
// j = +1..+k_fwd then -1..-k_back, and keeps the best candidate:
//
//   length   key equality attests 4*N_KEYS bytes; with two keys, a v0-only
//            match is 4 + ctz_bytes(v1 ^ v1'); each payload adds its
//            ctz_bytes while everything before it was equal; clipped to
//            limit = n_real - pos
//   valid    same v0, 0 < dist <= window, cand >= min_pos, len >= 4, and
//            the neighbour inside [0, n)
//   score    lbs*len - 30*floor(log2 dist); a candidate replaces the best
//            only on a strictly greater score (an argmax, ties to the
//            earliest offset)
//   short    (FUSE_SHORT) for j > 0 a v0-only candidate capped at 8,
//            merged at the end only if strictly better
//   output   packed (len << len_shift) | dist and the score, both zeroed
//            unless score > 100
//
// Precondition (every caller's sort gives it, ops/fold_cuda.py): the rows
// are sorted with v0 as the primary key, so rows of equal v0 are
// contiguous; with one key the sort is stable and pos is the original
// index, so pos ascends inside a run of equal v0.
//
// Exact early exits, taken from that order:
//   - every configuration: a scan direction stops at the first neighbour
//     of another v0 (none further out can have the row's v0);
//   - one key, forward: dist grows with j inside the run, so the scan also
//     stops at the first dist > window, at the first cand < min_pos, and
//     at the first j where lbs*min(4*(1 + N_PAY), limit) - 30*floor(log2
//     dist) <= best: no later candidate can score strictly more.  The
//     backward neighbours of a one-key row lie after it in position order
//     (dist < 0), so it has no backward scan;
//   - a row whose limit is below 4 has no valid candidate.
// ops/fold_cuda.py:fold_sorted_exits is the same scan in torch; it gives
// fold_sorted_ref's outputs and counts the pairs these exits leave.
//
// Bound on an H100: a launch reads each operand word once and writes 8
// bytes a row: 4,718,592 rows of the q9 main fold move 132 MB (0.039 ms at
// 3.35 TB/s).  The operations are about 20 a (row, offset) pair the exits
// leave; chip_smoke.py counts those pairs on its inputs
// (fold_sorted_exits), and the bytes bound the q2-q6 and two-key folds.
// The first port (one thread a row, every candidate 2 + N_KEYS + N_PAY
// global loads, no exits) was bound by the instructions it issued for
// every pair.  This design cuts the instructions a pair and the pairs:
//   - candidates tiled in shared memory: a CTA stages its tile of
//     kTileRows sorted rows, plus k_fwd rows before and k_back rows after
//     (rows outside [0, n) are never read), as one record a row: key0,
//     [key1], pos, payloads.  The first 4 words lie in plane 0, the rest
//     in plane 1 at a fixed distance, so a candidate is one or two LDS.128
//     off one pointer, and the lanes of a warp, reading consecutive
//     records, hit distinct banks.  The pack into records needs a pass
//     through registers, so the staging is plain coalesced loads and one
//     STS.128 a plane (cp.async into operand arrays and a pack after it
//     was slower, PERF.md);
//   - few instructions a pair: the exits above; branch-free updates of
//     the best; the length chain as the first unequal chained word
//     (selects, not a branch a word), its equal low bytes one clz of words
//     bit-reversed at staging; with one key the three exits one compare
//     each;
//   - COMPACT (one key, at most one payload): the exits
//     leave rows of very different lengths (most stop within a few
//     candidates, some scan all k_fwd), and a warp runs as long as its
//     longest lane.  So every row scans its first kRound0 offsets, the
//     rows still open are compacted into a shared-memory list
//     (__ballot_sync, __popc, one atomicAdd a warp) with their running
//     best, and the list's rows finish their scans spread over all lanes
//     of the CTA.  A row's offsets stay in scan order, so the carried best
//     is the argmax the sequential scan keeps.  Elsewhere one lane owns a
//     row for its whole scan: with two keys the exits leave 90% of the
//     pairs, and with five payloads the list cost more than the idle
//     lanes it saved (PERF.md).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kDistanceBitPenalty = 30;
constexpr int kMinScoreDelta = 100;
constexpr int kMaxPay = 5;
constexpr int kThreads = 256;
constexpr int kTileRows = 512;      // sorted rows a CTA folds
constexpr int kMaxOffsets = 64;
constexpr int kPlaneStride = kTileRows + kMaxOffsets;  // int4, plane 0 to 1
constexpr int kRound0 = 8;          // offsets a row scans before the list
constexpr int kListWords = 3;       // an open row's entry: row, best, packed
constexpr int kMaxDevices = 16;
constexpr int kMaxSmem = 232448;    // shared bytes a CTA (H100)

struct Params {
    const uint32_t* key0;
    const uint32_t* key1;
    const int32_t* pos;
    const uint32_t* pay[kMaxPay];
    int32_t* out_packed;
    int32_t* out_score;
    int n, n_real, k_fwd, k_back, window, lbs, len_shift, min_pos;
};

// One record a row: key0, [key1], pos, payloads, the chained words ([key1],
// payloads) bit-reversed so that their equal low bytes are leading zeros.
// The first 4 words lie in plane 0, the rest in plane 1 (kPlaneStride int4
// further on, an immediate offset), so lanes reading consecutive records
// read consecutive 16-byte words of each plane.
template <int N_KEYS, int N_PAY>
struct Rec {
    static constexpr int kWords = N_KEYS + 1 + N_PAY;
    static constexpr int kPlanes = kWords <= 4 ? 1 : 2;
    static constexpr int kLenMax = 4 * (N_KEYS + N_PAY);
};

// The record whose plane-0 word is at c.
template <int N_KEYS, int N_PAY>
__device__ __forceinline__ void load_rec(const int4* c, uint32_t (&w)[8]) {
    const int4 a = c[0];
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    if (Rec<N_KEYS, N_PAY>::kPlanes == 2) {
        const int4 b = c[kPlaneStride];
        w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    }
}

// Equal low bytes of two words, from the XOR of their bit reversals.
__device__ __forceinline__ int equal_low_bytes(uint32_t x_reversed) {
    return __clz(static_cast<int>(x_reversed)) >> 3;   // 4 when x == 0
}

// Record word of chained word c ([key1], payloads): what a candidate's
// length chains over after v0.
template <int N_KEYS>
__host__ __device__ constexpr int chain_word(int c) {
    return N_KEYS == 2 && c == 0 ? 1 : 2 + c;
}

// A row's scan state.  dbase: the distances a candidate may have (dist in
// [1, dbase]); top: the most a candidate can score, lbs * min(len_max,
// limit).
template <int N_KEYS, int N_PAY, bool FUSE_SHORT>
struct Row {
    uint32_t k0;
    uint32_t q[N_KEYS - 1 + N_PAY > 0 ? N_KEYS - 1 + N_PAY : 1];
    int32_t p, limit, dbase, top;
    int32_t best, packed, sbest, spacked;
};

template <int N_KEYS, int N_PAY, bool FUSE_SHORT>
__device__ __forceinline__ Row<N_KEYS, N_PAY, FUSE_SHORT> load_row(
    const int4* c, const Params& prm) {
    uint32_t w[8];
    load_rec<N_KEYS, N_PAY>(c, w);
    Row<N_KEYS, N_PAY, FUSE_SHORT> r;
    r.k0 = w[0];
    r.p = static_cast<int32_t>(w[N_KEYS]);
    // the words a candidate's length chains over: [key1], payloads
    if (N_KEYS == 2) r.q[0] = w[1];
#pragma unroll
    for (int k = 0; k < N_PAY; ++k) r.q[N_KEYS - 1 + k] = w[N_KEYS + 1 + k];
    r.limit = prm.n_real - r.p;
    r.dbase = max(0, min(prm.window, r.p - prm.min_pos));
    r.top = prm.lbs * min(Rec<N_KEYS, N_PAY>::kLenMax, r.limit);
    r.best = r.packed = r.sbest = r.spacked = 0;
    return r;
}

// One candidate (its record words w) for row r; returns true where the
// scan in this direction stops.  FWD: j > 0.
template <int N_KEYS, int N_PAY, bool FUSE_SHORT, bool FWD>
__device__ __forceinline__ bool step(Row<N_KEYS, N_PAY, FUSE_SHORT>& r,
                                     const uint32_t (&w)[8],
                                     const Params& prm) {
    constexpr int NW = N_KEYS - 1 + N_PAY;   // chained words
    const int32_t dist = r.p - static_cast<int32_t>(w[N_KEYS]);
    const int32_t pen = kDistanceBitPenalty * (31 - __clz(dist));
    const bool in_range = static_cast<uint32_t>(dist - 1) <
                          static_cast<uint32_t>(r.dbase);
    if (N_KEYS == 1) {
        // past the v0 run, the window or min_pos, or the score bound
        if ((w[0] != r.k0) | !in_range | (r.top - pen <= r.best))
            return true;
    } else if (w[0] != r.k0) {
        return true;   // past the v0 run
    }
    // length: 4 for v0, 4 for each chained word up to the first unequal
    // one, and that word's equal low bytes
    int32_t total = 4;
    if (NW > 0) {
        uint32_t xf = w[chain_word<N_KEYS>(NW - 1)] ^ r.q[NW - 1];
        int k = NW - 1;
#pragma unroll
        for (int c = NW - 2; c >= 0; --c) {
            const uint32_t x = w[chain_word<N_KEYS>(c)] ^ r.q[c];
            xf = x != 0u ? x : xf;
            k = x != 0u ? c : k;
        }
        total += 4 * k + equal_low_bytes(xf);
    }
    // limit >= 4 (rows below have no scan), so ml >= 4 and a candidate is
    // valid wherever dist is in range
    const int32_t ml = min(total, r.limit);
    const int32_t sc = prm.lbs * ml - pen;
    const bool upd = (N_KEYS == 1 || in_range) && sc > r.best;
    r.packed = upd ? ((ml << prm.len_shift) | dist) : r.packed;
    r.best = upd ? sc : r.best;
    if (FUSE_SHORT && FWD) {
        const int32_t mls = min(min(total, 8), r.limit);
        const int32_t scs = prm.lbs * mls - pen;
        const bool upds = in_range && scs > r.sbest;
        r.spacked = upds ? ((mls << prm.len_shift) | dist) : r.spacked;
        r.sbest = upds ? scs : r.sbest;
    }
    return false;
}

template <int N_KEYS, int N_PAY, bool FUSE_SHORT>
__device__ __forceinline__ void finish(
    const Row<N_KEYS, N_PAY, FUSE_SHORT>& r, const Params& prm, int g) {
    int32_t b = r.best, bp = r.packed;
    if (FUSE_SHORT && r.sbest > b) {
        b = r.sbest;
        bp = r.spacked;
    }
    const bool gate = b > kMinScoreDelta;
    prm.out_packed[g] = gate ? bp : 0;
    prm.out_score[g] = gate ? b : 0;
}

__device__ __forceinline__ int4 vec(uint32_t a, uint32_t b, uint32_t c,
                                    uint32_t d) {
    return make_int4(static_cast<int>(a), static_cast<int>(b),
                     static_cast<int>(c), static_cast<int>(d));
}

// Stage rows [base - k_fwd, base + rows + k_back) inside [0, n) as records.
template <int N_KEYS, int N_PAY>
__device__ __forceinline__ void stage(int4* plane0, const Params& prm,
                                      int base, int rows) {
    constexpr int NW = N_KEYS - 1 + N_PAY;
    const int lo = base - prm.k_fwd;
    const int n_loc = rows + prm.k_fwd + prm.k_back;
    for (int l = threadIdx.x; l < n_loc; l += kThreads) {
        const int g = lo + l;
        if (g < 0 || g >= prm.n) continue;
        uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
        w[0] = __ldg(prm.key0 + g);
        if (N_KEYS == 2) w[1] = __ldg(prm.key1 + g);
        w[N_KEYS] = static_cast<uint32_t>(__ldg(prm.pos + g));
#pragma unroll
        for (int k = 0; k < N_PAY; ++k)
            w[N_KEYS + 1 + k] = __ldg(prm.pay[k] + g);
#pragma unroll
        for (int c = 0; c < NW; ++c)
            w[chain_word<N_KEYS>(c)] = __brev(w[chain_word<N_KEYS>(c)]);
        plane0[l] = vec(w[0], w[1], w[2], w[3]);
        if (Rec<N_KEYS, N_PAY>::kPlanes == 2)
            plane0[kPlaneStride + l] = vec(w[4], w[5], w[6], w[7]);
    }
}

// One lane a row for the whole scan.
template <int N_KEYS, int N_PAY, bool FUSE_SHORT>
__device__ __forceinline__ void fold_rows(const int4* plane0,
                                          const Params& prm, int base,
                                          int rows) {
    for (int lr = threadIdx.x; lr < rows; lr += kThreads) {
        const int g = base + lr;
        const int4* const own = plane0 + lr + prm.k_fwd;
        auto r = load_row<N_KEYS, N_PAY, FUSE_SHORT>(own, prm);
        if (r.limit >= 4) {
            const int4* const first = own - min(prm.k_fwd, g);
            for (const int4* c = own - 1; c >= first; --c) {
                uint32_t w[8];
                load_rec<N_KEYS, N_PAY>(c, w);
                if (step<N_KEYS, N_PAY, FUSE_SHORT, true>(r, w, prm)) break;
            }
            if (N_KEYS == 2) {
                const int4* const last = own + min(prm.k_back, prm.n - 1 - g);
                for (const int4* c = own + 1; c <= last; ++c) {
                    uint32_t w[8];
                    load_rec<N_KEYS, N_PAY>(c, w);
                    if (step<N_KEYS, N_PAY, FUSE_SHORT, false>(r, w, prm))
                        break;
                }
            }
        }
        finish(r, prm, g);
    }
}

// One key (forward only), in two rounds: every row scans its first
// kRound0 offsets, the rows still open are compacted into a list (row,
// best, packed; an open row has scanned exactly kRound0 offsets), and the
// list's rows scan the rest spread over all lanes of the CTA.  list:
// kListWords arrays of kTileRows words.
template <int N_PAY>
__device__ __forceinline__ void fold_compact(const int4* plane0,
                                             int32_t* list,
                                             const Params& prm, int base,
                                             int rows) {
    constexpr int T = kTileRows;
    __shared__ int count;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    for (int round = 0; round < 2; ++round) {
        const int n_in = round == 0 ? rows : count;
        for (int e0 = 0; e0 < n_in; e0 += kThreads) {
            const int e = e0 + threadIdx.x;
            bool open = false;
            int lr = 0;
            Row<1, N_PAY, false> r;
            if (e < n_in) {
                lr = round == 0 ? e : list[e];
                const int g = base + lr;
                const int4* const own = plane0 + lr + prm.k_fwd;
                r = load_row<1, N_PAY, false>(own, prm);
                if (round == 1) {
                    r.best = list[T + e];
                    r.packed = list[2 * T + e];
                }
                // this round's offsets: t0 + 1 .. end
                const int kf = min(prm.k_fwd, g);
                const int t0 = round == 0 ? 0 : kRound0;
                const int end = round == 0 ? min(kf, kRound0) : kf;
                bool stopped = r.limit < 4;
                if (!stopped) {
                    for (const int4* c = own - t0 - 1; c >= own - end; --c) {
                        uint32_t w[8];
                        load_rec<1, N_PAY>(c, w);
                        if (step<1, N_PAY, false, true>(r, w, prm)) {
                            stopped = true;
                            break;
                        }
                    }
                }
                if (stopped || end >= kf) {
                    finish(r, prm, g);
                } else {
                    open = true;
                }
            }
            if (round == 0) {
                const unsigned m = __ballot_sync(0xffffffffu, open);
                if (m != 0u) {
                    const int leader = __ffs(static_cast<int>(m)) - 1;
                    int at = 0;
                    if (lane == leader) at = atomicAdd(&count, __popc(m));
                    at = __shfl_sync(0xffffffffu, at, leader);
                    if (open) {
                        const int k = at + __popc(m & ((1u << lane) - 1u));
                        list[k] = lr;
                        list[T + k] = r.best;
                        list[2 * T + k] = r.packed;
                    }
                }
            }
        }
        if (round == 0) __syncthreads();
    }
}

template <int N_KEYS, int N_PAY, bool FUSE_SHORT, bool COMPACT>
__global__ void __launch_bounds__(kThreads)
fold_kernel(Params prm) {
    extern __shared__ __align__(16) unsigned char fold_smem[];
    int4* plane0 = reinterpret_cast<int4*>(fold_smem);
    const int base = blockIdx.x * kTileRows;
    const int rows = min(kTileRows, prm.n - base);
    stage<N_KEYS, N_PAY>(plane0, prm, base, rows);
    __syncthreads();
    if constexpr (COMPACT) {
        // one plane (at most 3 words a record), then the list
        int32_t* list = reinterpret_cast<int32_t*>(
            plane0 + kTileRows + prm.k_fwd + prm.k_back);
        fold_compact<N_PAY>(plane0, list, prm, base, rows);
    } else {
        fold_rows<N_KEYS, N_PAY, FUSE_SHORT>(plane0, prm, base, rows);
    }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// The route each configuration takes (ops/fold_cuda.py:fold_plan mirrors
// it): COMPACT for one key and at most one payload.
constexpr bool compact_route(int n_keys, int n_pay) {
    return n_keys == 1 && n_pay <= 1;
}

// Dynamic shared bytes of a CTA: the record planes, and with COMPACT the
// list.
long smem_bytes_for(int n_keys, int n_pay, int k_fwd, int k_back) {
    const long n_rec = kTileRows + k_fwd + k_back;
    long b = 16 * (n_keys + 1 + n_pay <= 4 ? n_rec : kPlaneStride + n_rec);
    if (compact_route(n_keys, n_pay)) b += 4L * kListWords * kTileRows;
    return b;
}

template <int N_KEYS, int N_PAY, bool FUSE_SHORT>
cudaError_t launch(const Params& prm, int ctas, int smem,
                   cudaStream_t stream) {
    constexpr bool COMPACT = compact_route(N_KEYS, N_PAY);
    // the largest dynamic shared size set so far, an attribute of the
    // function on each card
    static int sized[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (smem > sized[dev]) {
        e = cudaFuncSetAttribute(
            fold_kernel<N_KEYS, N_PAY, FUSE_SHORT, COMPACT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        sized[dev] = smem;
    }
    fold_kernel<N_KEYS, N_PAY, FUSE_SHORT, COMPACT>
        <<<ctas, kThreads, smem, stream>>>(prm);
    return cudaGetLastError();
}

template <int N_KEYS, bool FUSE_SHORT>
cudaError_t launch_pay(int n_pay, const Params& prm, int ctas, int smem,
                       cudaStream_t stream) {
    switch (n_pay) {
#define FOLD_CASE(P) \
    case P:          \
        return launch<N_KEYS, P, FUSE_SHORT>(prm, ctas, smem, stream);
        FOLD_CASE(0)
        FOLD_CASE(1)
        FOLD_CASE(2)
        FOLD_CASE(3)
        FOLD_CASE(4)
        FOLD_CASE(5)
#undef FOLD_CASE
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Launches the fold on `stream` (a cudaStream_t) on the plan of
// ops/fold_cuda.py:fold_plan: `ctas` CTAs of 256 threads, each folding
// `tile_rows` (kTileRows) sorted rows in `smem` bytes of dynamic shared
// memory.
// Operands are int32 device arrays of length n (key and payload words
// read as uint32); `pays_in` is a host array of the n_pay payload
// pointers.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int fold_sorted_launch(
    const void* key0, const void* key1, const void* pos,
    const void* const* pays_in, int n_pay, void* out_packed,
    void* out_score, int n, int n_real, int n_keys, int fuse_short,
    int k_fwd, int k_back, int window, int lbs, int len_shift, int min_pos,
    int tile_rows, int ctas, int smem, void* stream) {
    if (n <= 0 || k_fwd < 0 || k_back < 0 || k_fwd + k_back > kMaxOffsets ||
        n_pay < 0 || n_pay > kMaxPay || (n_keys != 1 && n_keys != 2) ||
        (fuse_short && n_keys != 2) || window < 0 || lbs < 0 ||
        lbs > (1 << 20) || len_shift < 0 || len_shift > 31 ||
        tile_rows != kTileRows || static_cast<long>(ctas) * kTileRows < n ||
        static_cast<long>(ctas - 1) * kTileRows >= n ||
        smem != smem_bytes_for(n_keys, n_pay, k_fwd, k_back) ||
        smem > kMaxSmem)
        return static_cast<int>(cudaErrorInvalidValue);
    Params prm{};
    prm.key0 = static_cast<const uint32_t*>(key0);
    prm.key1 = static_cast<const uint32_t*>(key1);
    prm.pos = static_cast<const int32_t*>(pos);
    for (int k = 0; k < n_pay; ++k)
        prm.pay[k] = static_cast<const uint32_t*>(pays_in[k]);
    prm.out_packed = static_cast<int32_t*>(out_packed);
    prm.out_score = static_cast<int32_t*>(out_score);
    prm.n = n;
    prm.n_real = n_real;
    prm.k_fwd = k_fwd;
    prm.k_back = k_back;
    prm.window = window;
    prm.lbs = lbs;
    prm.len_shift = len_shift;
    prm.min_pos = min_pos;
    auto st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (n_keys == 1)
        e = launch_pay<1, false>(n_pay, prm, ctas, smem, st);
    else if (fuse_short)
        e = launch_pay<2, true>(n_pay, prm, ctas, smem, st);
    else
        e = launch_pay<2, false>(n_pay, prm, ctas, smem, st);
    return static_cast<int>(e);
}
