// Match-length round chain, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel brotli_tpu/ops/pallas_match.py:_kernel
// (launched by match_rounds_pallas).  For every candidate m of the
// round-major operands va, vb (uint32 [R, M]):
//
//   out[m] = sum over r of ctz_bytes(va[r, m] ^ vb[r, m]) while every
//            earlier round's XOR was 0  (ctz_bytes(0) == 4)
//
// so out[m] is the common prefix length in bytes of two 4R-byte strings
// given as R little-endian words, 0..4R.
//
// Two forms share one device body (chain_body):
//
//   match_rounds_kernel          the two operands va, vb, as the Pallas
//                                kernel takes them
//   match_rounds_shifted_kernel  the fold form of ops/matching.py
//                                _fold_sorted: vb is va shifted by j
//                                (zero words where m < j), for every
//                                j = 1..K at once; out is int32 [K, M]
//
// Bound on an H100: bytes.  A chain needs its rounds up to the first
// unequal one.  The two-operand form reads 8 bytes a needed round; the
// fold form reads each va word that some chain needs once (as the left
// or the right side, for any j) and writes 4K bytes a row.
//
// Design:
//   - one thread a row, 128 a CTA; a warp walks its 32 rows' rounds in
//     batches (TWO_BATCH, FOLD_BATCH rounds), all of a batch's loads
//     issued before its first compare: round r + 1's word is in flight
//     while round r is compared, and rounds 0 and 1 (which most rows
//     need) cost one memory latency.  After a batch, a ballot a offset
//     says which chains of the warp live on; the warp stops when none
//     does, and a lane loads the next batch's words only where a live
//     chain needs them: its own, or, in the fold form, that of the row
//     j places to its right.  The words of a round are coalesced.
//   - the fold form never builds the shifted copy: lane l takes
//     va[r, m - j] from lane l - j by a shuffle, and the first K lanes
//     of a warp load the K words left of the warp (the previous warp's
//     line, in L1/L2) as a halo, which lanes l < j take by a shuffle.
//   - the batch sizes and the CTA size are the fastest of those timed on
//     an H100 (research/design_sweep.py, PERF.md): a batch after the
//     first reads sparse 32-byte sectors, which the card serves at a
//     lower rate than whole lines, so the first batch reads every row's
//     words even where its chain ended a round earlier; loading the next
//     batch before this one's compares, on the live chains of the batch
//     before, was slower.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;     // ops/match_rounds_cuda.THREADS
constexpr int MAX_K = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;
// rounds a batch (see the design note above)
constexpr int TWO_BATCH = 2, FOLD_BATCH = 4;

// A round's words of one lane: a = va[r, m]; b = vb[r, m] in the
// two-operand form, else the halo word va[r, warp's first row - K + l]
// (lanes l < K).
struct Words {
    uint32_t a, b;
};

template <int K, bool TWO, int BATCH>
__device__ __forceinline__ void chain_body(const uint32_t* __restrict__ va,
                                           const uint32_t* __restrict__ vb,
                                           int32_t* __restrict__ out,
                                           int rounds, int64_t m) {
    const int lane = threadIdx.x & 31;
    const int64_t base = static_cast<int64_t>(blockIdx.x) * THREADS +
                         (threadIdx.x & ~31);
    const int64_t i = base + lane;
    const bool in = i < m;
    const int64_t hi = base - K + lane;   // the halo row of lane < K
    // (a warp past m loads nothing: its halo rows may lie past m too)
    const bool has_halo = !TWO && lane < K && hi >= 0 && base < m;

    // rounds r0 .. r0 + BATCH - 1 of the words the masks ask for (0
    // elsewhere: the zero halo left of row 0, words no chain reads, and
    // rounds past the last)
    Words w[BATCH];
    auto load = [&](int r0, uint32_t own, uint32_t halo) {
        const bool po = in && ((own >> lane) & 1u);
        const bool ph = has_halo && ((halo >> lane) & 1u);
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const int64_t o = static_cast<int64_t>(r0 + b) * m;
            const bool r_in = r0 + b < rounds;
            w[b].a = po && r_in ? __ldg(va + o + i) : 0u;
            if (TWO)
                w[b].b = po && r_in ? __ldg(vb + o + i) : 0u;
            else
                w[b].b = ph && r_in ? __ldg(va + o + hi) : 0u;
        }
    };

    uint32_t alive = in ? (1u << K) - 1u : 0u;   // bit j - 1: offset j
    int32_t total[K];
#pragma unroll
    for (int j = 0; j < K; ++j) total[j] = 0;

    load(0, FULL, FULL);
    for (int r0 = 0;;) {
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            if (r0 + b >= rounds) break;
#pragma unroll
            for (int j = 1; j <= K; ++j) {
                uint32_t y;
                if (TWO) {
                    y = w[b].b;
                } else {
                    const uint32_t up =
                        __shfl_sync(FULL, w[b].a, (lane - j) & 31);
                    const uint32_t left =
                        __shfl_sync(FULL, w[b].b, (lane - j + K) & 31);
                    y = lane >= j ? up : left;
                }
                const uint32_t x = w[b].a ^ y;
                const uint32_t bit = 1u << (j - 1);
                if (alive & bit) {
                    total[j - 1] +=
                        x ? (__ffs(static_cast<int>(x)) - 1) >> 3 : 4;
                    if (x) alive &= ~bit;
                }
            }
        }
        r0 += BATCH;
        if (r0 >= rounds) break;
        // which lanes' words a live chain of this warp reads from now on
        uint32_t own = 0u, halo = 0u;
        if (TWO) {
            own = __ballot_sync(FULL, alive != 0u);
        } else {
#pragma unroll
            for (int j = 1; j <= K; ++j) {
                const uint32_t bj =
                    __ballot_sync(FULL, (alive >> (j - 1)) & 1u);
                own |= bj | (bj >> j);
                halo |= bj << (K - j);
            }
            halo &= (1u << K) - 1u;
        }
        if (own == 0u) break;
        load(r0, own, halo);
    }
    if (in) {
#pragma unroll
        for (int j = 0; j < K; ++j) out[j * m + i] = total[j];
    }
}

__global__ void __launch_bounds__(THREADS)
match_rounds_kernel(const uint32_t* __restrict__ va,
                    const uint32_t* __restrict__ vb,
                    int32_t* __restrict__ out, int rounds, int64_t m) {
    chain_body<1, true, TWO_BATCH>(va, vb, out, rounds, m);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
match_rounds_shifted_kernel(const uint32_t* __restrict__ va,
                            int32_t* __restrict__ out, int rounds,
                            int64_t m) {
    chain_body<K, false, FOLD_BATCH>(va, nullptr, out, rounds, m);
}

template <int K>
cudaError_t launch_shifted(const void* va, void* out, int rounds, int64_t m,
                           unsigned ctas, cudaStream_t stream) {
    match_rounds_shifted_kernel<K><<<ctas, THREADS, 0, stream>>>(
        static_cast<const uint32_t*>(va), static_cast<int32_t*>(out), rounds,
        m);
    return cudaGetLastError();
}

bool bad_grid(int rounds, int64_t m, int threads, int64_t ctas) {
    return rounds < 1 || m <= 0 || m > INT32_MAX || threads != THREADS ||
           ctas * threads < m || (ctas - 1) * threads >= m;
}

}  // namespace

// Launches the two-operand chain on `stream` (a cudaStream_t).  va and
// vb are int32 device arrays [rounds, m] (row-major, read as uint32),
// out an int32 device array [m]; threads and ctas are the grid of
// ops/match_rounds_cuda.py:match_rounds_plan.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape or grid the kernel does not take.
extern "C" int match_rounds_launch(const void* va, const void* vb,
                                   void* out, int rounds, int64_t m,
                                   int threads, int64_t ctas, void* stream) {
    if (bad_grid(rounds, m, threads, ctas))
        return static_cast<int>(cudaErrorInvalidValue);
    match_rounds_kernel<<<static_cast<unsigned>(ctas), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(va), static_cast<const uint32_t*>(vb),
        static_cast<int32_t*>(out), rounds, m);
    return static_cast<int>(cudaGetLastError());
}

// Launches the fold form for offsets j = 1..k (1 <= k <= 8): va int32
// [rounds, m], out int32 [k, m], out[j - 1, i] the chain of va[:, i]
// against va[:, i - j] (zero words where i < j).  Returns as
// match_rounds_launch.
extern "C" int match_rounds_shifted_launch(const void* va, void* out,
                                           int rounds, int64_t m, int k,
                                           int threads, int64_t ctas,
                                           void* stream) {
    if (bad_grid(rounds, m, threads, ctas) || k < 1 || k > MAX_K)
        return static_cast<int>(cudaErrorInvalidValue);
    const unsigned g = static_cast<unsigned>(ctas);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = cudaErrorInvalidValue;
    switch (k) {
        case 1: e = launch_shifted<1>(va, out, rounds, m, g, s); break;
        case 2: e = launch_shifted<2>(va, out, rounds, m, g, s); break;
        case 3: e = launch_shifted<3>(va, out, rounds, m, g, s); break;
        case 4: e = launch_shifted<4>(va, out, rounds, m, g, s); break;
        case 5: e = launch_shifted<5>(va, out, rounds, m, g, s); break;
        case 6: e = launch_shifted<6>(va, out, rounds, m, g, s); break;
        case 7: e = launch_shifted<7>(va, out, rounds, m, g, s); break;
        case 8: e = launch_shifted<8>(va, out, rounds, m, g, s); break;
    }
    return static_cast<int>(e);
}
