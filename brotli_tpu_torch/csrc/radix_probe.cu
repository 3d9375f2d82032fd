// The radix-sort probes' primitives: CUDA kernels for sm_90a.
//
// Counterparts of the six Pallas kernels of research/radix_probe.py
// (P2-P5) and research/radix_probe2.py (Q1), the building blocks a
// counting sort on the device would be made of.  Each computes what the
// TPU body computes on an int32 array of rows of 128 lanes, not its
// block structure:
//
//   gather_rows   research/radix_probe.py:96 (gather_kernel, launched by
//                 make_gather) and radix_probe2.py:64 (gather_kernel):
//                 out[b*R + i, l] = x[b*R + idx[b*R + i, l], l], R a
//                 runtime argument.
//                 One thread per output element: idx and out coalesced,
//                 x gathered from its R-row block (at most 4 MiB, in L2).
//   gather_lanes  research/radix_probe.py:156 (gather1_kernel):
//                 out[r, l] = x[r, idx[r, l]].  A block stages 8 rows of
//                 512 bytes in shared memory and gathers from there.
//   hist8         research/radix_probe.py:187 (hist_kernel), the function
//                 its body means (its `.reshape(1, 128)` does not trace):
//                 out[8*t + q, l] = #{rows i of 2048-row tile t :
//                 (x[i, l] & 7) == q}.  A block counts one tile's 32-lane
//                 group into all 256 byte-digit bins in shared memory
//                 (256 x 32 x 4 B = 32 KiB, digit-major so the 32 lanes of
//                 a warp hit 32 banks) and folds the bins by digit % 8 when
//                 it writes out: the count step of a radix sort at B = 256.
//                 The sums are exact, so the order of the atomics does not
//                 matter.
//   run_copy      research/radix_probe.py:229 (copy_kernel): K runs of C
//                 rows from src to dst at the same offsets.  One block per
//                 run, 16-byte vector loads and stores.  Runs may overlap;
//                 they write the same values from the same source rows.
//   cmpex3        research/radix_probe.py:268 (cmpex_kernel): three
//                 compare-exchange stages s = 1, 2, 4 inside each 2048-row
//                 tile: y[i] = x[(i - s) mod 2048], x[i] = ((i / s) % 2 ==
//                 0) ? min(x[i], y[i]) : max(x[i], y[i]).  Output row i
//                 depends on input rows i-7 .. i (mod 2048), so a thread
//                 takes a run of 32 rows of one lane with the 7 rows
//                 before it in registers and runs the stages there.
//
// What bounds them on this card: bytes.  Each reads its inputs once and
// writes its output once (gathers 12 B an element, hist8 4 B, cmpex3
// 8 B, run_copy 1 KiB a covered row) with a few integer operations per
// element; none is anywhere near the 67 T/s integer rate.  These first
// versions are plain and right; making them fast is later work.
//
// Every launcher returns the CUDA error code of its launch (0 on
// success); pointers are device pointers, the stream a cudaStream_t.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;        // lanes of a row
constexpr int kTile = 2048;        // rows of a hist8 / cmpex3 tile
constexpr int kLaneRows = 8;       // rows a gather_lanes block stages
constexpr int kBins = 256;         // byte digits hist8 counts
constexpr int kGroup = 32;         // lanes a hist8 block counts
constexpr int kHistThreads = 1024;
constexpr int kCmpexRun = 32;      // output rows of one cmpex3 thread
constexpr int kCmpexHalo = 7;      // rows before them it reads (1 + 2 + 4)
constexpr int kThreads = 256;

__global__ void gather_rows_kernel(const int32_t* __restrict__ x,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, int64_t n,
                                   int rows_per_block) {
  int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n) return;
  int64_t row = t / kLanes;
  int64_t base = row - row % rows_per_block;
  out[t] = x[(base + idx[t]) * kLanes + (t % kLanes)];
}

__global__ void gather_lanes_kernel(const int32_t* __restrict__ x,
                                    const int32_t* __restrict__ idx,
                                    int32_t* __restrict__ out, int rows) {
  __shared__ int32_t row_of[kLaneRows][kLanes];
  int r = blockIdx.x * kLaneRows + threadIdx.y;
  int64_t at = static_cast<int64_t>(r) * kLanes + threadIdx.x;
  if (r < rows) row_of[threadIdx.y][threadIdx.x] = x[at];
  __syncthreads();
  if (r < rows) out[at] = row_of[threadIdx.y][idx[at]];
}

__global__ void __launch_bounds__(kHistThreads)
hist8_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out) {
  __shared__ int32_t bins[kBins * kGroup];   // [digit][lane]
  const int tile = blockIdx.x;
  const int lane = threadIdx.x % kGroup;
  const int col = blockIdx.y * kGroup + lane;
  for (int i = threadIdx.x; i < kBins * kGroup; i += kHistThreads) bins[i] = 0;
  __syncthreads();
  const int32_t* src = x + static_cast<int64_t>(tile) * kTile * kLanes + col;
  for (int r = threadIdx.x / kGroup; r < kTile; r += kHistThreads / kGroup) {
    int d = src[static_cast<int64_t>(r) * kLanes] & (kBins - 1);
    atomicAdd(&bins[d * kGroup + lane], 1);
  }
  __syncthreads();
  if (threadIdx.x < 8 * kGroup) {
    const int q = threadIdx.x / kGroup;   // digit % 8
    int sum = 0;
    for (int k = 0; k < kBins / 8; ++k)
      sum += bins[(8 * k + q) * kGroup + lane];
    out[(static_cast<int64_t>(tile) * 8 + q) * kLanes + col] = sum;
  }
}

__global__ void run_copy_kernel(const int4* __restrict__ src,
                                int4* __restrict__ dst,
                                const int32_t* __restrict__ offs,
                                int run_vecs) {
  const int64_t base = static_cast<int64_t>(offs[blockIdx.x]) * (kLanes / 4);
  for (int i = threadIdx.x; i < run_vecs; i += blockDim.x)
    dst[base + i] = src[base + i];
}

// stage s of the compare-exchange at row `row` of its tile: min where
// (row / s) % 2 == 0, else max (s a power of two)
__device__ __forceinline__ int32_t cmpex(int row, int s, int32_t a,
                                         int32_t b) {
  return (row & s) == 0 ? min(a, b) : max(a, b);
}

__global__ void cmpex3_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ out, int64_t n_threads) {
  int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n_threads) return;
  const int lane = t % kLanes;
  const int64_t run = t / kLanes;
  const int64_t tile = run / (kTile / kCmpexRun);
  const int r0 = (run % (kTile / kCmpexRun)) * kCmpexRun - kCmpexHalo;
  const int64_t at = tile * kTile * kLanes + lane;
  constexpr int kW = kCmpexRun + kCmpexHalo;
  // a[p] holds row (r0 + p) mod 2048 of the tile; each stage updates from
  // the top down, so a[p - s] still holds the stage before
  int32_t a[kW];
#pragma unroll
  for (int p = 0; p < kW; ++p)
    a[p] = x[at + static_cast<int64_t>((r0 + p) & (kTile - 1)) * kLanes];
#pragma unroll
  for (int p = kW - 1; p >= 1; --p)
    a[p] = cmpex((r0 + p) & (kTile - 1), 1, a[p], a[p - 1]);
#pragma unroll
  for (int p = kW - 1; p >= 3; --p)
    a[p] = cmpex((r0 + p) & (kTile - 1), 2, a[p], a[p - 2]);
#pragma unroll
  for (int p = kW - 1; p >= kCmpexHalo; --p)
    a[p] = cmpex((r0 + p) & (kTile - 1), 4, a[p], a[p - 4]);
#pragma unroll
  for (int p = kCmpexHalo; p < kW; ++p)
    out[at + static_cast<int64_t>(r0 + p) * kLanes] = a[p];
}

unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int gather_rows_launch(const void* x, const void* idx, void* out,
                                  int rows, int rows_per_block,
                                  void* stream) {
  const int64_t n = static_cast<int64_t>(rows) * kLanes;
  gather_rows_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), n, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_lanes_launch(const void* x, const void* idx, void* out,
                                   int rows, void* stream) {
  const dim3 block(kLanes, kLaneRows);
  gather_lanes_kernel<<<(rows + kLaneRows - 1) / kLaneRows, block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hist8_launch(const void* x, void* out, int rows,
                            void* stream) {
  const dim3 grid(rows / kTile, kLanes / kGroup);
  hist8_kernel<<<grid, kHistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int run_copy_launch(const void* src, void* dst, const void* offs,
                               int runs, int run_rows, void* stream) {
  run_copy_kernel<<<runs, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst),
      static_cast<const int32_t*>(offs), run_rows * (kLanes / 4));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cmpex3_launch(const void* x, void* out, int rows,
                             void* stream) {
  const int64_t n = static_cast<int64_t>(rows / kCmpexRun) * kLanes;
  cmpex3_kernel<<<blocks_for(n), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
