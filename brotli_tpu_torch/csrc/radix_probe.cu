// The radix-sort probes' primitives: CUDA kernels for sm_90a.
//
// Counterparts of the six Pallas kernels of research/radix_probe.py
// (P2-P5) and research/radix_probe2.py (Q1), the building blocks a
// counting sort on the device would be made of.  Each computes what the
// TPU body computes on an int32 array of rows of 128 lanes, not its
// block structure.  All offsets are 32-bit: the wrappers take at most
// 2^31 / 128 rows.
//
//   gather_rows   replaces research/radix_probe.py:96 (gather_kernel,
//                 launched by make_gather at :102) and radix_probe2.py:64
//                 (gather_kernel, launched at :70):
//                 out[b*R + i, l] = x[b*R + idx[b*R + i, l], l].
//                 Bound: bytes, 12 B an element (x and idx read once, out
//                 written once).  The gather never leaves its lane, so a
//                 block (CTA) stages a strip of R rows x W lanes of x in
//                 shared memory with 16-byte cp.async, one HBM read per
//                 byte in row segments of 4 W bytes, and gathers from
//                 there: a thread reads 4 lanes of idx as one int4, takes
//                 4 values from the strip and writes one int4 of out.
//                 Two routes, picked by the wrapper from R:
//                   smem     R <= 2048: a strip of about 64 KiB (16,384
//                            elements; W = 128 at R <= 128, 64 at 256,
//                            16 at 1024, 8 at 2048), several R-blocks a
//                            CTA when R is small, 3 CTAs an SM;
//                   l2       R > 2048: x read through L2 (21 MB fits), a
//                            32-byte sector for each 4-byte element; a
//                            strip of 64 KiB there would have W <= 4, and
//                            its 16-byte row segments cost more than that.
//                 Banks: a thread takes its 4 lanes in an order rotated
//                 by its place in the warp, so at W >= 32 the 32 reads of
//                 one step hit 32 banks whatever idx holds; at W < 32 a
//                 row is narrower than the banks and random rows still
//                 meet some conflicts (shared memory is not the bound).
//   gather_lanes  replaces research/radix_probe.py:156 (gather1_kernel,
//                 launched at :161): out[r, l] = x[r, idx[r, l]].
//                 Bound: bytes, 12 B an element.  One warp per row, 4
//                 rows in flight a warp (x and idx as int4, every byte
//                 read once), the rows staged in a per-warp buffer of
//                 4 x 512 bytes behind __syncwarp (no block barrier), one
//                 int4 of out a thread and row; a grid-stride loop.
//   hist8         research/radix_probe.py:187 (hist_kernel), the function
//                 its body means (its `.reshape(1, 128)` does not trace):
//                 out[8*t + q, l] = #{rows i of 2048-row tile t :
//                 (x[i, l] & 0xFF) % 8 == q}.  It counts all 256 byte
//                 digits and folds them by digit % 8 only when it writes
//                 out: the probe asks what the count step of a radix sort
//                 at B = 256 costs ("256 equality sweeps per tile"), and a
//                 kernel that counted x & 7 directly would give the same
//                 output without answering it.
//                 Bound: bytes, 4 B an element read once.  Each (tile,
//                 32-lane group) is split over a cluster of kHistCluster
//                 = 4 CTAs of 512 rows (320 CTAs on the probes' 40,960
//                 rows, every SM busy; 2 and 8 were slower, PERF.md).
//                 A warp reads one row's 32
//                 lanes (128 B) a load; each thread keeps 8 rows' loads
//                 in flight, the next 8 issued before the shared atomics
//                 of the last, and the first issued before the bins are
//                 zeroed.  The loads are cache-streaming (ld.global.cs:
//                 evict-first in L1 and L2), so the lines of a tile, read
//                 once, replace each other in L2 and not what the caller
//                 keeps there (1.09x by device time after the 128 MiB
//                 write of devtime.device_ms, on an NVIDIA H100 80GB
//                 HBM3, 700.00 W; PERF.md).  Bins: 16-bit counters, two digits to a word,
//                 [digit / 2][lane] (16 KiB, every lane of a warp in its
//                 own bank whatever the digits).  The fold: warp q sums
//                 digits q, q + 8, ... into a partial [8][32] in shared
//                 memory; after a cluster barrier rank r of CL sums the
//                 cluster's partials of rows q in [8r / CL, 8(r+1) / CL)
//                 through distributed shared memory and writes them: no
//                 global atomics, no memset, one launch.  The sums are
//                 exact, so the order of the atomics does not matter.
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
// element; none is anywhere near the 67 T/s integer rate.
//
// Every launcher returns the CUDA error code of its launch (0 on
// success); pointers are device pointers, the stream a cudaStream_t.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;        // lanes of a row
constexpr int kTile = 2048;        // rows of a hist8 / cmpex3 tile
constexpr int kBins = 256;         // byte digits hist8 counts
constexpr int kGroup = 32;         // lanes a hist8 CTA counts
constexpr int kHistWarps = 8;      // a hist8 CTA; warp q folds digit % 8 == q
constexpr int kHistBatch = 8;      // rows' loads a hist8 thread keeps in flight
constexpr int kHistCluster = 4;    // CTAs that split a hist8 tile
constexpr int kCmpexRun = 32;      // output rows of one cmpex3 thread
constexpr int kCmpexHalo = 7;      // rows before them it reads (1 + 2 + 4)
constexpr int kThreads = 256;
constexpr int kStrip = 16384;      // elements of x a gather_rows CTA stages
constexpr int kPrefetch = 4;       // idx int4 loads a thread keeps ahead
constexpr int kLaneWarps = 8;      // warps of a gather_lanes CTA
constexpr int kLaneRows = 4;       // rows in flight per gather_lanes warp
constexpr int kMaxDevices = 64;    // cards a process may launch on

enum Route { kSmem = 0, kL2 = 1 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ int4 ld_int4(const int32_t* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// out.s = v[(s + r) & 3]
__device__ __forceinline__ int4 rot4(int4 v, int r) {
  if (r == 1) return make_int4(v.y, v.z, v.w, v.x);
  if (r == 2) return make_int4(v.z, v.w, v.x, v.y);
  if (r == 3) return make_int4(v.w, v.x, v.y, v.z);
  return v;
}

// Row of the strip where the R-block of strip row i starts: a mask for
// a power-of-two R (magic == 0), else floor(i / R) * R by a multiply-high
// with magic = floor(2^32 / R) + 1, exact for i, R < 2^16.
__device__ __forceinline__ int block_start(int i, int R, unsigned magic) {
  return magic == 0u ? (i & ~(R - 1))
                     : static_cast<int>(__umulhi(static_cast<unsigned>(i),
                                                 magic)) * R;
}

// One int4 of out from the strip xs (rows of W lanes): the 4 lanes col ..
// col + 3 of a row whose R-block starts at strip row `start`, idx a.  The
// lanes are taken in the order rot, rot + 1, ... (mod 4).
template <int W>
__device__ __forceinline__ int4 gather4(const int32_t* xs, int start,
                                        int col, int4 a, int rot) {
  const int4 ar = rot4(a, rot);
  int4 g;
  g.x = xs[(start + ar.x) * W + col + (rot & 3)];
  g.y = xs[(start + ar.y) * W + col + ((rot + 1) & 3)];
  g.z = xs[(start + ar.z) * W + col + ((rot + 2) & 3)];
  g.w = xs[(start + ar.w) * W + col + ((rot + 3) & 3)];
  return rot4(g, (4 - rot) & 3);
}

// The smem route.  CTA c stages lanes [l0, l0 + W) of R-blocks
// [b0, b0 + blocks_per_cta) (the last group may hold fewer), then each
// thread gathers int4 items it = tid, tid + 256, ... of the strip, item
// it being strip row it / (W / 4), lanes 4 (it % (W / 4)) + 0..3.
template <int W>
__global__ void __launch_bounds__(kThreads, 3)
gather_rows_smem_kernel(const int32_t* __restrict__ x,
                        const int32_t* __restrict__ idx,
                        int32_t* __restrict__ out, int R, unsigned magic,
                        int blocks_per_cta, int n_blocks) {
  constexpr int kQ = W / 4;                // int4 items of a strip row
  constexpr int kStrips = kLanes / W;
  // a warp's 32 items sit at 32 consecutive items; lanes 4 (t % 8) of
  // one step meet the rotation's 4 offsets when W >= 32
  constexpr int kRotShift = kQ >= 8 ? 3 : (kQ == 4 ? 2 : 1);
  extern __shared__ int4 smem[];
  int32_t* xs = reinterpret_cast<int32_t*>(smem);
  const int group = blockIdx.x / kStrips;
  const int l0 = (blockIdx.x % kStrips) * W;
  const int b0 = group * blocks_per_cta;
  const int rows = min(blocks_per_cta, n_blocks - b0) * R;
  const int items = rows * kQ;
  const int at0 = b0 * R * kLanes + l0;    // x / idx / out offset of item 0
  for (int it = threadIdx.x; it < items; it += kThreads)
    cp_async16(xs + it * 4, x + at0 + (it / kQ) * kLanes + (it % kQ) * 4);
  int4 a[kPrefetch];
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k) {
    const int it = threadIdx.x + k * kThreads;
    a[k] = it < items ? ld_int4(idx + at0 + (it / kQ) * kLanes + (it % kQ) * 4)
                      : make_int4(0, 0, 0, 0);
  }
  cp_async_wait_all();
  __syncthreads();
  const int rot = ((threadIdx.x & 31) >> kRotShift) & 3;
  for (int it0 = threadIdx.x; it0 < items; it0 += kPrefetch * kThreads) {
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int it = it0 + k * kThreads;
      const int4 cur = a[k];
      const int nxt = it + kPrefetch * kThreads;
      if (nxt < items)
        a[k] = ld_int4(idx + at0 + (nxt / kQ) * kLanes + (nxt % kQ) * 4);
      if (it < items) {
        const int i = it / kQ;
        const int col = (it % kQ) * 4;
        *reinterpret_cast<int4*>(out + at0 + i * kLanes + col) =
            gather4<W>(xs, block_start(i, R, magic), col, cur, rot);
      }
    }
  }
}

// The l2 route: blockIdx.y is the R-block, each thread one int4 item of
// it (row item / 32, lanes 4 (item % 32) + 0..3), x read through L2.
__global__ void __launch_bounds__(kThreads)
gather_rows_l2_kernel(const int32_t* __restrict__ x,
                      const int32_t* __restrict__ idx,
                      int32_t* __restrict__ out, int R) {
  const int item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= R * (kLanes / 4)) return;
  const int start = blockIdx.y * R * kLanes + (item % (kLanes / 4)) * 4;
  const int at = start + (item / (kLanes / 4)) * kLanes;
  const int4 a = ld_int4(idx + at);
  const int32_t* xb = x + start;
  *reinterpret_cast<int4*>(out + at) =
      make_int4(__ldg(xb + a.x * kLanes), __ldg(xb + a.y * kLanes + 1),
                __ldg(xb + a.z * kLanes + 2), __ldg(xb + a.w * kLanes + 3));
}

__global__ void __launch_bounds__(kLaneWarps * 32)
gather_lanes_kernel(const int32_t* __restrict__ x,
                    const int32_t* __restrict__ idx,
                    int32_t* __restrict__ out, int rows) {
  __shared__ int4 buf[kLaneWarps][kLaneRows][kLanes / 4];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int32_t* rows_of = reinterpret_cast<const int32_t*>(buf[w]);
  const int stride = gridDim.x * kLaneWarps * kLaneRows;
  for (int r0 = (blockIdx.x * kLaneWarps + w) * kLaneRows; r0 < rows;
       r0 += stride) {
    int4 xv[kLaneRows], iv[kLaneRows];
#pragma unroll
    for (int k = 0; k < kLaneRows; ++k) {
      const int at = (r0 + k) * kLanes + 4 * t;
      const bool in = r0 + k < rows;
      xv[k] = in ? ld_int4(x + at) : make_int4(0, 0, 0, 0);
      iv[k] = in ? ld_int4(idx + at) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kLaneRows; ++k) buf[w][k][t] = xv[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kLaneRows; ++k) {
      if (r0 + k < rows) {
        const int32_t* row = rows_of + k * kLanes;
        *reinterpret_cast<int4*>(out + (r0 + k) * kLanes + 4 * t) =
            make_int4(row[iv[k].x], row[iv[k].y], row[iv[k].z],
                      row[iv[k].w]);
      }
    }
    __syncwarp();   // the buffer is read before the next rows land
  }
}

// One CTA of a cluster of CL: rows [rank * 2048 / CL, (rank + 1) * 2048 /
// CL) of tile blockIdx.x / CL, lanes [32 blockIdx.y, 32 blockIdx.y + 32).
__global__ void __launch_bounds__(kHistWarps * 32)
hist8_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out) {
  constexpr int CL = kHistCluster;
  constexpr int kRows = kTile / CL / kHistWarps;   // rows of one warp
  constexpr int kBatch = kRows < kHistBatch ? kRows : kHistBatch;
  constexpr int kOut = 8 * kGroup / CL;            // outputs a rank writes
  static_assert(kRows % kBatch == 0 && (8 * kGroup) % CL == 0, "hist8 grid");
  // bins[j][lane]: digit 2j in the low half, 2j + 1 in the high half
  __shared__ uint4 bins4[kBins / 2 * kGroup / 4];
  __shared__ int32_t part[8 * kGroup];             // [digit % 8][lane]
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / CL;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t* src =
      x + (static_cast<int64_t>(tile) * kTile + rank * (kTile / CL) + warp) *
              kLanes + blockIdx.y * kGroup + lane;
  constexpr int64_t kStep = static_cast<int64_t>(kHistWarps) * kLanes;
  int v[kBatch];
#pragma unroll
  for (int b = 0; b < kBatch; ++b) v[b] = __ldcs(src + b * kStep);
  for (int i = threadIdx.x; i < kBins / 2 * kGroup / 4; i += kHistWarps * 32)
    bins4[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  unsigned* bins = reinterpret_cast<unsigned*>(bins4);
#pragma unroll
  for (int i0 = 0; i0 < kRows; i0 += kBatch) {
    int nxt[kBatch];
    if (i0 + kBatch < kRows) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        nxt[b] = __ldcs(src + (i0 + kBatch + b) * kStep);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const unsigned d = static_cast<unsigned>(v[b]) & (kBins - 1);
      atomicAdd(&bins[(d >> 1) * kGroup + lane], 1u << ((d & 1) * 16));
    }
    if (i0 + kBatch < kRows) {
#pragma unroll
      for (int b = 0; b < kBatch; ++b) v[b] = nxt[b];
    }
  }
  __syncthreads();
  // warp q: digits q + 8m sit in word (q >> 1) + 4m, half q & 1
  const unsigned shift = (warp & 1) * 16;
  int sum = 0;
#pragma unroll
  for (int m = 0; m < kBins / 8; ++m)
    sum += (bins[((warp >> 1) + 4 * m) * kGroup + lane] >> shift) & 0xFFFF;
  part[warp * kGroup + lane] = sum;
  cluster.sync();
  if (threadIdx.x < kOut) {
    const int at = rank * kOut + threadIdx.x;   // q * 32 + lane
    int total = 0;
#pragma unroll
    for (int r = 0; r < CL; ++r) total += cluster.map_shared_rank(part, r)[at];
    out[(static_cast<int64_t>(tile) * 8 + at / kGroup) * kLanes +
        blockIdx.y * kGroup + at % kGroup] = total;
  }
  cluster.sync();   // no CTA leaves while another reads its partial
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

// smem route instances by strip width; each may take 64 KiB of dynamic
// shared memory, an attribute of the function set once on each card
template <int W>
cudaError_t launch_smem(const int32_t* x, const int32_t* idx, int32_t* out,
                        int R, unsigned magic, int g, int n_blocks,
                        unsigned ctas, size_t smem_bytes,
                        cudaStream_t stream) {
  static bool sized[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(gather_rows_smem_kernel<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStrip * 4);
    if (e != cudaSuccess) return e;
    sized[dev] = true;
  }
  gather_rows_smem_kernel<W><<<ctas, kThreads, smem_bytes, stream>>>(
      x, idx, out, R, magic, g, n_blocks);
  return cudaGetLastError();
}

}  // namespace

// gather_rows by route (0 smem, 1 l2) on the grid the wrapper plans from
// R (ops/radix_cuda.py:gather_rows_plan).  smem: grid_x CTAs, each a
// strip of `lanes` lanes over `blocks_per_cta` R-blocks in `smem_bytes`
// of dynamic shared memory; l2: grid_x CTAs an R-block by grid_y
// R-blocks.
extern "C" int gather_rows_launch(const void* x, const void* idx, void* out,
                                  int rows, int R, int route, int lanes,
                                  int blocks_per_cta, int grid_x, int grid_y,
                                  int smem_bytes, void* stream) {
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* ip = static_cast<const int32_t*>(idx);
  auto* op = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int n_blocks = rows / R;
  if (route == kSmem) {
    if (R * lanes > kStrip || blocks_per_cta < 1 || grid_y != 1 ||
        smem_bytes > kStrip * 4)
      return cudaErrorInvalidValue;
    const unsigned magic =
        (R & (R - 1)) == 0 ? 0u
                           : static_cast<unsigned>((1ull << 32) / R + 1);
    const unsigned ctas = grid_x;
    const size_t bytes = smem_bytes;
    switch (lanes) {
      case 128: return launch_smem<128>(xp, ip, op, R, magic, blocks_per_cta,
                                        n_blocks, ctas, bytes, st);
      case 64: return launch_smem<64>(xp, ip, op, R, magic, blocks_per_cta,
                                      n_blocks, ctas, bytes, st);
      case 32: return launch_smem<32>(xp, ip, op, R, magic, blocks_per_cta,
                                      n_blocks, ctas, bytes, st);
      case 16: return launch_smem<16>(xp, ip, op, R, magic, blocks_per_cta,
                                      n_blocks, ctas, bytes, st);
      case 8: return launch_smem<8>(xp, ip, op, R, magic, blocks_per_cta,
                                    n_blocks, ctas, bytes, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route == kL2 && smem_bytes == 0) {
    const dim3 grid(grid_x, grid_y);
    gather_rows_l2_kernel<<<grid, kThreads, 0, st>>>(xp, ip, op, R);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

extern "C" int gather_lanes_launch(const void* x, const void* idx, void* out,
                                   int rows, int ctas, void* stream) {
  gather_lanes_kernel<<<ctas, kLaneWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

// hist8 on the grid of ops/radix_cuda.py:hist8_plan: (rows / 2048 x
// kHistCluster, 4) CTAs of 256 threads in clusters of kHistCluster.
extern "C" int hist8_launch(const void* x, void* out, int rows,
                            void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows / kTile * kHistCluster, kLanes / kGroup);
  cfg.blockDim = dim3(kHistWarps * 32);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kHistCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, hist8_kernel, static_cast<const int32_t*>(x),
      static_cast<int32_t*>(out));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
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
