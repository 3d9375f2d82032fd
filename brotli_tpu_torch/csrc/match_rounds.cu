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
// One thread per candidate.  For each round the threads of a warp read
// neighbouring words (coalesced), and a thread stops at its first
// unequal round, so the words it does not need are never read.  The
// Pallas kernel's 1024-candidate padding and (8, 128) blocks have no
// counterpart: a bounds check on M.
//
// Bound on an H100: bytes.  A candidate reads 8 bytes for each round up
// to its first unequal one and writes 4: at most 8R + 4 bytes, 285 MB at
// R = 8, M = 4,194,304 (85 us at 3.35 TB/s); a few integer operations per
// round read are far below that.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
match_rounds_kernel(const uint32_t* __restrict__ va,
                    const uint32_t* __restrict__ vb,
                    int32_t* __restrict__ out, int rounds, int64_t m) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= m) return;
    int32_t total = 0;
    for (int r = 0; r < rounds; ++r) {
        const uint32_t x = va[r * m + i] ^ vb[r * m + i];
        if (x != 0u) {
            total += (__ffs(static_cast<int>(x)) - 1) >> 3;
            break;
        }
        total += 4;
    }
    out[i] = total;
}

}  // namespace

// Launches the round chain on `stream` (a cudaStream_t).  va and vb are
// int32 device arrays [rounds, m] (row-major, read as uint32), out an
// int32 device array [m].  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int match_rounds_launch(const void* va, const void* vb,
                                   void* out, int rounds, int64_t m,
                                   void* stream) {
    if (rounds < 1 || m <= 0 || m > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 256;
    const int64_t blocks = (m + threads - 1) / threads;
    match_rounds_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(va), static_cast<const uint32_t*>(vb),
        static_cast<int32_t*>(out), rounds, m);
    return static_cast<int>(cudaGetLastError());
}
