// Static-dictionary probe of one compress_gpu span, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package probes the RFC 7932
// static dictionary on the host (brotli_tpu/encode/static_dict.py:
// add_dictionary_matches, numpy over every position); this kernel moves
// that probe onto the card, beside the span's bytes that the matcher
// already has there, so that compress_gpu's host leg only merges the
// candidates that beat the window's match.  The host encoders and
// compress_mesh keep the numpy probe.
//
// For every position p of the span [halo, end) of the row (end = halo +
// real), as add_dictionary_matches does it for one position:
//
//   hash     the 4 bytes at p (bytes at or past end read as 0) times
//            0x1E35A7BD, top 15 bits: a bucket of 2 entries of the
//            greedy tiers' index (static_dict.dict_index)
//   length   for each entry, the leading bytes equal to its word, up to
//            the word's length L and to end - p
//   valid    a length m >= 4 whose omit L - m is 0 or has a bare
//            OmitLast transform (static_dict.omit_last_transform_ids)
//   dist     min(p - min_pos, window) + 1 + (transform << size_bits[L])
//            + word index
//   score    135 * m - 30 * floor(log2 dist), signed (not written: the
//            host computes it again for the candidates it reads)
//   keep     slot 1 only where its score is strictly greater than slot
//            0's (the sequential loop's order)
//
// A position with a valid entry has a candidate: k << 36 | L << 31 |
// m << 26 | dist, k = p - halo its place in the span (dist < 2^26).  The
// output is one int64 array of span + ctas words (ops/dict_probe_cuda.py
// reads it): CTA c's candidates, in position order, at [256c, 256c +
// n_c), and n_c at word span + c; the rest of a CTA's 256 slots is left
// unwritten.  So the host reads the candidates alone, without a pass
// over every position.
//
// Bound on an H100: bytes.  A launch reads the span's real bytes once
// and writes 8 bytes a candidate and a count a CTA: a 524,288-byte span
// of the bulk mix with 16,284 candidates moves 0.67 MB (0.0002 ms at
// 3.35 TB/s).  The index (324 KB of words, 256 KB of buckets, 54 KB of
// entry fields) stays in L2 across launches.
//
// Design, right and simple first: one thread a position, 256 a CTA; the
// CTA stages its 256 bytes and 24 of tail in shared memory (one byte
// load a thread, coalesced), so a position's hash and compares read
// shared memory; the word bytes are compared one at a time from global
// memory (L1 / L2) and most compares end at the first or second byte.
// A CTA compacts its candidates by a ballot a warp and a prefix over its
// 8 warps' counts in shared memory.  The kernel's time hides under
// compress_gpu's pipeline, which keeps up to three dispatches in flight
// while the host works on a span.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;    // ops/dict_probe_cuda.THREADS
constexpr int kMaxWord = 24;     // static_dict.MAX_WORD_LEN
constexpr int kHashBits = 15;    // static_dict.DICT_HASH_BITS
constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr int kOmitIds = 10;     // omit 0..9
constexpr int kLbs = 135;        // score per byte of length
constexpr int kDistPenalty = 30;  // score per bit of distance
constexpr long long kNone = -0x7FFFFFFFFFFFFFFFLL - 1;
constexpr int kWarps = kThreads / 32;

struct Params {
    const uint8_t* row;
    const uint8_t* word_bytes;   // [entries, 24]
    const int32_t* word_meta;    // L | size_bits[L] << 8 | word index << 16
    const int32_t* table;        // [2^15, 2] entry ids, -1 empty
    long long* out;              // [span + ctas]
    int halo, end, span, min_pos, window;
    int omit_ids[kOmitIds];      // transform id of omit k, -1 none
};

// The best candidate of position pos (< end) as len << 31 | m << 26 |
// dist, or kNone.
__device__ long long probe(const Params& p, const uint8_t* s, int pos,
                           const int* omit_ids) {
    const uint32_t v = s[0] | s[1] << 8 | s[2] << 16
                       | static_cast<uint32_t>(s[3]) << 24;
    const uint32_t h = (v * kHashMul) >> (32 - kHashBits);
    const int avail = p.end - pos;
    const int base = min(pos - p.min_pos, p.window) + 1;
    long long best = kNone;
    int best_score = 0;
    for (int slot = 0; slot < 2; ++slot) {
        const int e = __ldg(p.table + 2 * h + slot);
        if (e < 0) continue;
        const int meta = __ldg(p.word_meta + e);
        const int len = meta & 0xFF;
        const int bits = (meta >> 8) & 0xFF;
        const int lim = min(len, avail);
        const uint8_t* w = p.word_bytes + e * kMaxWord;
        int m = 0;
        while (m < lim && s[m] == __ldg(w + m)) ++m;
        const int omit = len - m;
        if (m < 4 || omit >= kOmitIds) continue;
        const int tr = omit_ids[omit];
        if (tr < 0) continue;
        const int dist = base + (tr << bits) + (meta >> 16);
        const int score = kLbs * m - kDistPenalty * (31 - __clz(dist));
        if (best == kNone || score > best_score) {
            best_score = score;
            best = static_cast<long long>(len) << 31
                   | static_cast<long long>(m) << 26 | dist;
        }
    }
    return best;
}

__global__ void __launch_bounds__(kThreads)
dict_probe_kernel(Params p) {
    __shared__ uint8_t text[kThreads + kMaxWord];
    // read by a dynamic index: in shared memory, not a stack copy of p
    __shared__ int omit_ids[kOmitIds];
    __shared__ int warp_count[kWarps];
    const int first = blockIdx.x * kThreads;      // in the span
    for (int i = threadIdx.x; i < kThreads + kMaxWord; i += kThreads) {
        const int q = p.halo + first + i;
        text[i] = q < p.end ? p.row[q] : 0;
    }
    if (threadIdx.x == 0) {
#pragma unroll
        for (int i = 0; i < kOmitIds; ++i) omit_ids[i] = p.omit_ids[i];
    }
    __syncthreads();
    const int k = first + threadIdx.x;
    const int pos = p.halo + k;
    const long long best = pos < p.end
        ? probe(p, text + threadIdx.x, pos, omit_ids) : kNone;
    // compaction: a candidate's slot is the candidates before it in
    // the CTA
    const bool has = best != kNone;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, has);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = __popc(ballot & ((1u << lane) - 1)), total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_count[w] : 0;
        total += warp_count[w];
    }
    if (has) p.out[first + before] = static_cast<long long>(k) << 36 | best;
    if (threadIdx.x == 0) p.out[p.span + blockIdx.x] = total;
}

}  // namespace

// Launches the probe on `stream` (a cudaStream_t): `ctas` CTAs of 256
// threads cover the span's `span` positions (ops/dict_probe_cuda.
// probe_plan).  row: uint8 device array of halo + span bytes; out: int64
// [span + ctas]; word_bytes, word_meta, table: the index on the device;
// omit_ids: a host array of 10 transform ids.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape or plan the
// kernel does not take.
extern "C" int dict_probe_launch(const void* row, const void* word_bytes,
                                 const void* word_meta, const void* table,
                                 const int* omit_ids, void* out, int halo,
                                 int real, int span, int min_pos, int window,
                                 int threads, int ctas, void* stream) {
    if (halo < 0 || span <= 0 || span > (1 << 27) || real < 0 ||
        real > span || static_cast<long long>(halo) + span > 0x7FFFFFFFLL ||
        min_pos < 0 || min_pos > halo || window < 0 ||
        window > (1 << 24) || threads != kThreads ||
        static_cast<long long>(ctas) * kThreads < span ||
        static_cast<long long>(ctas - 1) * kThreads >= span)
        return static_cast<int>(cudaErrorInvalidValue);
    Params prm{};
    prm.row = static_cast<const uint8_t*>(row);
    prm.word_bytes = static_cast<const uint8_t*>(word_bytes);
    prm.word_meta = static_cast<const int32_t*>(word_meta);
    prm.table = static_cast<const int32_t*>(table);
    prm.out = static_cast<long long*>(out);
    prm.halo = halo;
    prm.end = halo + real;
    prm.span = span;
    prm.min_pos = min_pos;
    prm.window = window;
    for (int i = 0; i < kOmitIds; ++i) prm.omit_ids[i] = omit_ids[i];
    dict_probe_kernel<<<ctas, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(prm);
    return static_cast<int>(cudaGetLastError());
}
