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
//            n_real - pos
//   valid    same v0, 0 < dist <= window, cand >= min_pos, len >= 4, and
//            the neighbour inside [0, n)
//   score    lbs*len - 30*floor(log2 dist); a candidate replaces the best
//            only on a strictly greater score
//   short    (FUSE_SHORT) for j > 0 a v0-only candidate capped at 8,
//            merged at the end only if strictly better
//   output   packed (len << len_shift) | dist and the score, both zeroed
//            unless score > 100
//
// The Pallas kernel's lane rolls, 8-row halo blocks and TILE padding have
// no counterpart: a neighbour is a load at index i - j, and one outside
// [0, n) is invalid (the TPU padding rows carry pos = -2^30 and fail the
// window test, which gives the same result).
//
// Bound on an H100: each launch reads 4 bytes of each of the
// N_KEYS + 1 + N_PAY operands per row once and writes 8 bytes, about
// 132 MB for the q9 main fold at 4,718,592 rows (39 us at 3.35 TB/s); it
// does about 25 integer operations per row and offset, 5.7e9 for the q9
// main fold (24 offsets), which puts the floor on the operation side.
// This first version is one thread per row: neighbour loads of adjacent
// threads overlap and are served by L1/L2, so device memory is read about
// once.  Staging a tile plus its k_fwd + k_back halo in shared memory is
// left to a later change.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kDistanceBitPenalty = 30;
constexpr int kMinScoreDelta = 100;
constexpr int kMaxPay = 5;

struct Payloads {
    const uint32_t* p[kMaxPay];
};

__device__ __forceinline__ int ctz_bytes(uint32_t x) {
    return x == 0u ? 4 : ((__ffs(static_cast<int>(x)) - 1) >> 3);
}

template <int N_KEYS, int N_PAY, bool FUSE_SHORT>
__global__ void __launch_bounds__(256)
fold_kernel(const uint32_t* __restrict__ key0,
            const uint32_t* __restrict__ key1,
            const int32_t* __restrict__ pos, Payloads pays,
            int32_t* __restrict__ out_packed,
            int32_t* __restrict__ out_score, int n, int n_real,
            int k_fwd, int k_back, int window, int lbs, int len_shift,
            int min_pos) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t k0 = key0[i];
    uint32_t k1 = 0u;
    if (N_KEYS == 2) k1 = key1[i];
    uint32_t q[N_PAY > 0 ? N_PAY : 1];
#pragma unroll
    for (int r = 0; r < N_PAY; ++r) q[r] = pays.p[r][i];
    const int32_t p = pos[i];
    const int32_t limit = n_real - p;

    int32_t best_score = 0, best_packed = 0;
    int32_t short_score = 0, short_packed = 0;
    const int n_off = k_fwd + k_back;
    for (int t = 0; t < n_off; ++t) {
        const int j = t < k_fwd ? t + 1 : k_fwd - t - 1;
        const int c = i - j;
        if (c < 0 || c >= n) continue;
        // every candidate, short or not, needs the same v0
        if (key0[c] != k0) continue;
        int32_t total;
        bool alive;
        if (N_KEYS == 2) {
            const uint32_t x1 = key1[c] ^ k1;
            total = 4 + ctz_bytes(x1);
            alive = x1 == 0u;
        } else {
            total = 4;
            alive = true;
        }
#pragma unroll
        for (int r = 0; r < N_PAY; ++r) {
            const int m = ctz_bytes(pays.p[r][c] ^ q[r]);
            total += alive ? m : 0;
            alive = alive && m == 4;
        }
        const int32_t cand = pos[c];
        const int32_t dist = p - cand;
        if (dist <= 0 || dist > window || cand < min_pos) continue;
        const int32_t logd = 31 - __clz(dist);
        const int32_t ml = min(total, limit);
        if (ml >= 4) {
            const int32_t sc = lbs * ml - kDistanceBitPenalty * logd;
            if (sc > best_score) {
                best_score = sc;
                best_packed = (ml << len_shift) | dist;
            }
        }
        if (FUSE_SHORT && j > 0) {
            const int32_t mls = min(min(total, 8), limit);
            if (mls >= 4) {
                const int32_t sc = lbs * mls - kDistanceBitPenalty * logd;
                if (sc > short_score) {
                    short_score = sc;
                    short_packed = (mls << len_shift) | dist;
                }
            }
        }
    }
    if (FUSE_SHORT && short_score > best_score) {
        best_score = short_score;
        best_packed = short_packed;
    }
    const bool gate = best_score > kMinScoreDelta;
    out_packed[i] = gate ? best_packed : 0;
    out_score[i] = gate ? best_score : 0;
}

template <int N_KEYS, int N_PAY, bool FUSE_SHORT>
void launch(const uint32_t* key0, const uint32_t* key1, const int32_t* pos,
            Payloads pays, int32_t* out_packed, int32_t* out_score, int n,
            int n_real, int k_fwd, int k_back, int window, int lbs,
            int len_shift, int min_pos, cudaStream_t stream) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    fold_kernel<N_KEYS, N_PAY, FUSE_SHORT><<<blocks, threads, 0, stream>>>(
        key0, key1, pos, pays, out_packed, out_score, n, n_real, k_fwd,
        k_back, window, lbs, len_shift, min_pos);
}

template <int N_KEYS, bool FUSE_SHORT>
bool launch_pay(int n_pay, const uint32_t* key0, const uint32_t* key1,
                const int32_t* pos, Payloads pays, int32_t* out_packed,
                int32_t* out_score, int n, int n_real, int k_fwd,
                int k_back, int window, int lbs, int len_shift,
                int min_pos, cudaStream_t stream) {
    switch (n_pay) {
#define FOLD_CASE(P)                                                       \
    case P:                                                                \
        launch<N_KEYS, P, FUSE_SHORT>(key0, key1, pos, pays, out_packed,   \
                                      out_score, n, n_real, k_fwd, k_back, \
                                      window, lbs, len_shift, min_pos,     \
                                      stream);                             \
        return true;
        FOLD_CASE(0)
        FOLD_CASE(1)
        FOLD_CASE(2)
        FOLD_CASE(3)
        FOLD_CASE(4)
        FOLD_CASE(5)
#undef FOLD_CASE
        default:
            return false;
    }
}

}  // namespace

// Launches the fold on `stream` (a cudaStream_t).  Operands are int32
// device arrays of length n; key and payload words are read as uint32;
// `pays_in` is a host array of the n_pay payload pointers.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int fold_sorted_launch(
    const void* key0, const void* key1, const void* pos,
    const void* const* pays_in, int n_pay, void* out_packed,
    void* out_score, int n, int n_real, int n_keys, int fuse_short,
    int k_fwd, int k_back, int window, int lbs, int len_shift, int min_pos,
    void* stream) {
    if (n <= 0 || k_fwd < 0 || k_back < 0 || n_pay < 0 ||
        n_pay > kMaxPay || (n_keys != 1 && n_keys != 2))
        return static_cast<int>(cudaErrorInvalidValue);
    Payloads pays{};
    for (int r = 0; r < n_pay; ++r)
        pays.p[r] = static_cast<const uint32_t*>(pays_in[r]);
    auto k0 = static_cast<const uint32_t*>(key0);
    auto k1 = static_cast<const uint32_t*>(key1);
    auto ps = static_cast<const int32_t*>(pos);
    auto op = static_cast<int32_t*>(out_packed);
    auto os = static_cast<int32_t*>(out_score);
    auto st = static_cast<cudaStream_t>(stream);
    bool ok;
    if (n_keys == 1)
        ok = fuse_short
                 ? launch_pay<1, true>(n_pay, k0, k1, ps, pays, op, os, n,
                                       n_real, k_fwd, k_back, window, lbs,
                                       len_shift, min_pos, st)
                 : launch_pay<1, false>(n_pay, k0, k1, ps, pays, op, os, n,
                                        n_real, k_fwd, k_back, window, lbs,
                                        len_shift, min_pos, st);
    else
        ok = fuse_short
                 ? launch_pay<2, true>(n_pay, k0, k1, ps, pays, op, os, n,
                                       n_real, k_fwd, k_back, window, lbs,
                                       len_shift, min_pos, st)
                 : launch_pay<2, false>(n_pay, k0, k1, ps, pays, op, os, n,
                                        n_real, k_fwd, k_back, window, lbs,
                                        len_shift, min_pos, st);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
