// Batched Brotli symbol decode and the step-probe loop, for Hopper (sm_90a).
//
// decode_step_kernel takes the place of the lax.while_loop in
// brotli_tpu/ops/decode_tpu.py:batch_decode_device (decode_tpu.py:450),
// whose every step is a device-wide round trip, and is the design that
// the TPU probe research/decode_step_kernel_probe.py tested and could
// not build there: one thread owns one lane (one compressed metablock),
// keeps its decoder state in registers, and loops over symbol steps
// inside the kernel until the lane is done, falls back, or has run
// max_steps steps.  Each step is the while_loop body's phase machine
// (decode_tpu.py:223-448), for the lane's own phase only:
//
//   CMD     command symbol, with the insert/copy extras fused in when
//           symbol + extras fit the 57 guaranteed bits of the window
//   EXTRAS  the extras of a command whose extras did not fit
//   LIT     up to 3 literals from one window
//   DIST    an explicit distance (symbol + short/direct/extra bits);
//           most distances are fused into the step that finished the
//           literals instead
//   a copy past the lane's largest backward distance is a static-
//   dictionary word: the lane advances by the transform's output length
//
// and writes literals, (insert, copy, distance) commands, the counts,
// the end bit, the final phase (status) and the distance ring.  It
// equals ops/decode_gpu.py:batch_decode_ref bit for bit on every lane,
// including lanes that fall back: writes past the literal/command
// buffers are clipped to their last slot exactly as the JAX loop
// clips them, and the 64-bit window of a lane reads its row clipped to
// the batch's row length L (the longest lane re-reads its last byte).
//
// Bound on an H100: neither bytes nor operations.  A lane's steps are a
// dependent chain (window -> symbol -> next window) of scalar loads from
// its stream row and its trees; per step a few hundred integer
// operations and a handful of dependent loads.  The card-wide bounds
// (stream bytes + output bytes over 3.35 TB/s, counted operations over
// 67 T/s) sit far below the chain's latency.  The design keeps the
// chain short: trees as canonical first/limit/offset rows (15 compares
// per symbol, no per-lane lookup table), only the lane's phase decoded,
// and 32-thread blocks so 1024 lanes spread over 32 SMs.
//
// step_probe_kernel is TPU probe #9's kernel function
// (research/decode_step_kernel_probe.py:61-82, launched at :94): per
// lane, `steps` iterations of an LCG step and 0-2 dependent reads from
// the lane's table row.  One thread per lane; its time per step is this
// card's figure for the cost model the probe was written to measure.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int PH_CMD = 0, PH_EXTRAS = 1, PH_LIT = 2, PH_DIST = 3,
              PH_DONE = 4, PH_FALLBACK = 5;

// offsets into the int32 constant table (ops/decode_gpu.py _TABLE_LAYOUT)
constexpr int T_INS_BASE = 0, T_INS_EXTRA = 24, T_CPY_BASE = 48,
              T_CPY_EXTRA = 72, T_CMD2INS = 96, T_CMD2CPY = 800,
              T_IMPL0 = 1504, T_SC_IDX = 2208, T_SC_DELTA = 2224,
              T_DICT_SBITS = 2240, T_DICT_OUTLEN = 2265;

struct Tree {
    const int32_t* first;   // [N, 15]
    const int32_t* limit;   // [N, 15]
    const int32_t* offset;  // [N, 15]
    const int32_t* syms;    // [N, A]
    const int32_t* single;  // [N]
};

// Field order = the pointer and size arrays decode_step_launch takes.
struct Params {
    const uint8_t* data;  // [N, L]
    const int32_t *bit0, *mlen, *window, *npostfix, *ndirect, *out_prefix;
    const int32_t* cache0;  // [N, 4]
    const int32_t* table;   // [T_DICT_OUTLEN + 121 * 25]
    Tree tree[3];           // literal, command, distance
    uint8_t* lits;          // [N, s_lit]
    int32_t* cmds;          // [N, s_cmd, 3]
    int32_t *nlit, *ncmd, *end_bit, *status;
    int32_t* cache;  // [N, 4]
    int32_t* steps;  // [N]
    int64_t n, L, a_dist, max_steps, s_lit, s_cmd;
};
constexpr int kNumPtrs = 32;

struct LaneTree {
    const int32_t *first, *limit, *offset, *syms;
    int32_t single, a;
};

__device__ __forceinline__ LaneTree lane_tree(const Tree& t, int64_t i,
                                              int32_t a) {
    return LaneTree{t.first + 15 * i, t.limit + 15 * i, t.offset + 15 * i,
                    t.syms + a * i, __ldg(t.single + i), a};
}

__device__ __forceinline__ int32_t clampi(int32_t v, int32_t lo,
                                          int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// (lo >> k) | (hi << (32 - k)) for 0 < k < 32; lo for k == 0
__device__ __forceinline__ uint32_t shr_or(uint32_t lo, uint32_t hi,
                                           uint32_t k) {
    return k ? ((lo >> k) | (hi << (32u - k))) : lo;
}

// the 32 bits starting k (0 <= k < 64) bits into the window
__device__ __forceinline__ uint32_t shifted64(uint32_t w_lo, uint32_t w_hi,
                                              int32_t k) {
    const bool k32 = k >= 32;
    return shr_or(k32 ? w_hi : w_lo, k32 ? 0u : w_hi,
                  static_cast<uint32_t>(k & 31));
}

// low nb bits of v (nb < 32 on every path; all bits for nb >= 32, as
// the JAX loop's uint32 shift gives)
__device__ __forceinline__ uint32_t mask(uint32_t v, int32_t nb) {
    return nb >= 32 ? v : (v & ((1u << nb) - 1u));
}

__device__ __forceinline__ int32_t bitrev15(uint32_t x) {
    x = ((x & 0x5555u) << 1) | ((x >> 1) & 0x5555u);
    x = ((x & 0x3333u) << 2) | ((x >> 2) & 0x3333u);
    x = ((x & 0x0F0Fu) << 4) | ((x >> 4) & 0x0F0Fu);
    x = ((x & 0x00FFu) << 8) | ((x >> 8) & 0x00FFu);
    return static_cast<int32_t>((x >> 1) & 0x7FFFu);
}

// One symbol from the low 15 bits of w (ops/decode_gpu.py:_tree_decode):
// the first code length whose candidate lies in [first, limit); none
// found is "bad" and still reads the length-1 slot, as the plain
// version's argmax of an all-false row does.  A one-symbol tree costs
// 0 bits.
__device__ __forceinline__ void tree_decode(const LaneTree& t, uint32_t w,
                                            int32_t& sym, int32_t& nbits,
                                            bool& bad) {
    if (t.single >= 0) {
        sym = t.single;
        nbits = 0;
        bad = false;
        return;
    }
    const int32_t r = bitrev15(w & 0x7FFFu);
    int l = 0;
    bool found = false;
    for (; l < 15; ++l) {
        const int32_t c = r >> (14 - l);
        if (c < __ldg(t.limit + l) && c >= __ldg(t.first + l)) {
            found = true;
            break;
        }
    }
    if (!found) l = 0;
    const int32_t c = r >> (14 - l);
    const int32_t pos = clampi(__ldg(t.offset + l) + c - __ldg(t.first + l),
                               0, t.a - 1);
    sym = __ldg(t.syms + pos);
    nbits = l + 1;
    bad = !found;
}

struct Dist {
    int32_t d, bits, dcode;
    bool bad;
};

// Distance symbol + short-code / direct / extra bits, from the window
// (wl, wh) (decode_tpu.py dist_decode).
__device__ __forceinline__ Dist dist_decode(const LaneTree& t,
                                            const int32_t* tab,
                                            const int32_t cache[4],
                                            int32_t npostfix,
                                            int32_t ndirect, uint32_t wl,
                                            uint32_t wh) {
    int32_t d_sym, d_bits0;
    bool d_bad;
    tree_decode(t, wl, d_sym, d_bits0, d_bad);
    const int32_t dcode = clampi(d_sym, 0, t.a - 1);
    const int32_t d15 = clampi(dcode, 0, 15);
    const int32_t short_d =
        cache[clampi(__ldg(tab + T_SC_IDX + d15), 0, 3)] +
        __ldg(tab + T_SC_DELTA + d15);
    const int32_t direct_d = dcode - 16 + 1;
    const int32_t h = max(dcode - ndirect - 16, 0);
    const int32_t hcode = h >> npostfix;
    const int32_t lcode = h & ((1 << npostfix) - 1);
    const int32_t nbits_raw = 1 + (hcode >> 1);
    const int32_t nbits = clampi(nbits_raw, 0, 24);  // > 24 is malformed
    const int32_t offs = ((2 + (hcode & 1)) << nbits) - 4;
    const int32_t extra = static_cast<int32_t>(
        mask(shr_or(wl, wh, static_cast<uint32_t>(d_bits0)), nbits));
    const int32_t long_d =
        ((offs + extra) << npostfix) + lcode + ndirect + 1;
    const bool is_short = dcode < 16;
    const bool is_direct = !is_short && dcode < 16 + ndirect;
    Dist r;
    r.d = is_short ? short_d : (is_direct ? direct_d : long_d);
    r.bits = (is_short || is_direct) ? d_bits0 : d_bits0 + nbits;
    r.bad = d_bad || (is_short && r.d <= 0) ||
            (!is_short && !is_direct && nbits_raw > 24);
    r.dcode = dcode;
    return r;
}

__global__ void __launch_bounds__(32)
decode_step_kernel(const Params p) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
    if (i >= p.n) return;
    const int32_t* tab = p.table;
    const uint8_t* row = p.data + i * p.L;
    const int64_t last = p.L - 1;
    const LaneTree lit = lane_tree(p.tree[0], i, 256);
    const LaneTree cmd = lane_tree(p.tree[1], i, 704);
    const LaneTree dst = lane_tree(p.tree[2], i,
                                   static_cast<int32_t>(p.a_dist));
    const int32_t mlen = p.mlen[i], window = p.window[i];
    const int32_t npostfix = p.npostfix[i], ndirect = p.ndirect[i];
    const int32_t out_prefix = p.out_prefix[i];
    const int32_t s_lit = static_cast<int32_t>(p.s_lit);
    const int32_t s_cmd = static_cast<int32_t>(p.s_cmd);
    uint8_t* lits = p.lits + i * p.s_lit;
    int32_t* cmds = p.cmds + i * p.s_cmd * 3;

    int32_t bit = p.bit0[i], phase = PH_CMD, out_len = 0;
    int32_t ins_code = 0, cpy_code = 0, ins_rem = 0, cur_ins = 0;
    int32_t copy_len = 0, impl = 0, nlit = 0, ncmd = 0;
    int32_t cache[4];
    for (int k = 0; k < 4; ++k) cache[k] = p.cache0[4 * i + k];

    int64_t step = 0;
    for (; step < p.max_steps && phase < PH_DONE; ++step) {
        // 64-bit window at `bit`, bytes clipped to the row
        uint32_t lo = 0, hi = 0;
        const int64_t byte = bit >> 3;
        for (int b = 0; b < 4; ++b) {
            const int64_t j0 = byte + b, j1 = byte + 4 + b;
            lo |= static_cast<uint32_t>(
                      row[j0 < 0 ? 0 : (j0 > last ? last : j0)])
                  << (8 * b);
            hi |= static_cast<uint32_t>(
                      row[j1 < 0 ? 0 : (j1 > last ? last : j1)])
                  << (8 * b);
        }
        const uint32_t sh = static_cast<uint32_t>(bit & 7);
        const uint32_t w_lo = shr_or(lo, hi, sh);
        const uint32_t w_hi = sh ? hi >> sh : hi;

        const bool is_cmd = phase == PH_CMD, is_ext = phase == PH_EXTRAS;
        const bool is_lit = phase == PH_LIT, is_dst = phase == PH_DIST;

        // command symbol, extras fused when they fit
        int32_t c_sym = 0, c_bits = 0, n_ins = 0, n_cpy = 0, n_impl = 0;
        bool c_bad = false;
        if (is_cmd) {
            tree_decode(cmd, w_lo, c_sym, c_bits, c_bad);
            c_sym = clampi(c_sym, 0, 703);
            n_ins = __ldg(tab + T_CMD2INS + c_sym);
            n_cpy = __ldg(tab + T_CMD2CPY + c_sym);
            n_impl = __ldg(tab + T_IMPL0 + c_sym);
        }
        const int32_t ic_eff = is_cmd ? n_ins : ins_code;
        const int32_t cc_eff = is_cmd ? n_cpy : cpy_code;
        const int32_t base_off = is_cmd ? c_bits : 0;
        const int32_t iebits = __ldg(tab + T_INS_EXTRA + ic_eff);
        const int32_t cebits = __ldg(tab + T_CPY_EXTRA + cc_eff);
        const bool fits = base_off + iebits + cebits <= 57;
        const int32_t v_ins = static_cast<int32_t>(
            mask(shifted64(w_lo, w_hi, base_off), iebits));
        const int32_t v_cpy = static_cast<int32_t>(
            mask(shifted64(w_lo, w_hi, base_off + iebits), cebits));
        const int32_t e_ins_len = __ldg(tab + T_INS_BASE + ic_eff) + v_ins;
        const int32_t e_cpy_len = __ldg(tab + T_CPY_BASE + cc_eff) + v_cpy;
        const int32_t e_bits = iebits + cebits;

        // up to 3 literals from one window
        const bool take2 = is_lit && ins_rem >= 2;
        const bool take3 = is_lit && ins_rem >= 3;
        int32_t l_sym = 0, l_bits = 0, l_sym2 = 0, l_bits2 = 0;
        int32_t l_sym3 = 0, l_bits3 = 0;
        bool l_bad = false, l_bad2 = false, l_bad3 = false;
        if (is_lit) {
            tree_decode(lit, w_lo, l_sym, l_bits, l_bad);
            if (take2)
                tree_decode(lit, shifted64(w_lo, w_hi, l_bits), l_sym2,
                            l_bits2, l_bad2);
            if (take3)
                tree_decode(lit, shifted64(w_lo, w_hi, l_bits + l_bits2),
                            l_sym3, l_bits3, l_bad3);
        }
        const int32_t nl = int32_t(is_lit) + int32_t(take2) + int32_t(take3);
        const int32_t lit_bits = l_bits + l_bits2 + l_bits3;

        Dist dd{0, 0, 0, false};
        if (is_dst)
            dd = dist_decode(dst, tab, cache, npostfix, ndirect, w_lo, w_hi);

        const bool ext_eff = (is_cmd && fits) || is_ext;
        const int32_t consumed =
            is_cmd ? c_bits + (fits ? e_bits : 0)
                   : (is_ext ? e_bits
                             : (is_lit ? lit_bits : (is_dst ? dd.bits : 0)));
        int32_t nbit = bit + consumed;
        bool bad = (is_cmd && c_bad) || l_bad || l_bad2 || l_bad3 ||
                   (is_dst && dd.bad);

        const int32_t mrem = mlen - out_len;
        if (is_cmd) {
            ins_code = n_ins;
            cpy_code = n_cpy;
            impl = n_impl;
        }
        const bool e_over = ext_eff && e_ins_len > mrem;
        if (ext_eff) {
            ins_rem = e_ins_len;
            cur_ins = e_ins_len;
            copy_len = e_cpy_len;
        }

        // emit the literals (writes clipped to the buffer, in order)
        if (is_lit) lits[clampi(nlit, 0, s_lit - 1)] = uint8_t(l_sym);
        if (take2) lits[clampi(nlit + 1, 0, s_lit - 1)] = uint8_t(l_sym2);
        if (take3) lits[clampi(nlit + 2, 0, s_lit - 1)] = uint8_t(l_sym3);
        nlit += nl;
        out_len += nl;
        ins_rem -= nl;

        const bool lit_done = (is_lit && ins_rem == 0) ||
                              (ext_eff && !e_over && e_ins_len == 0);
        const bool block_end = lit_done && out_len == mlen;
        const bool use_impl = lit_done && !block_end && impl == 1;
        const int32_t impl_dist = cache[0];

        // the distance fused into this step, where the window covers it
        const bool want_f = lit_done && !block_end && impl == 0;
        bool is_fdst = false;
        Dist fd{0, 0, 0, false};
        if (want_f) {
            const int32_t f_off =
                is_cmd ? c_bits + e_bits : (is_ext ? e_bits : lit_bits);
            const bool k32 = f_off >= 32;
            const uint32_t lo2 = k32 ? w_hi : w_lo, hi2 = k32 ? 0u : w_hi;
            const uint32_t kk = static_cast<uint32_t>(f_off & 31);
            fd = dist_decode(dst, tab, cache, npostfix, ndirect,
                             shr_or(lo2, hi2, kk), kk ? hi2 >> kk : hi2);
            is_fdst = !fd.bad && f_off <= 42 && f_off + fd.bits <= 57;
        }
        const int32_t max_dist = min(out_len + out_prefix, window);

        // copy: implicit, fused or DIST step; past max_dist it is a
        // static-dictionary word of the transform's output length
        const bool is_copy = use_impl || is_dst || is_fdst;
        const int32_t eff_dist =
            is_dst ? dd.d : (is_fdst ? fd.d : impl_dist);
        const bool is_dictref = is_copy && eff_dist > max_dist;
        const int32_t word_id = eff_dist - max_dist - 1;
        const bool cl_ok = copy_len >= 4 && copy_len <= 24;
        const int32_t cl_idx = clampi(copy_len, 0, 24);
        const int32_t sb = __ldg(tab + T_DICT_SBITS + cl_idx);
        const int32_t transform = sb < 31 ? (word_id >> sb) : 121;
        const bool dict_ok =
            is_dictref && cl_ok && transform < 121 && word_id >= 0;
        const int32_t dict_add = __ldg(
            tab + T_DICT_OUTLEN + 25 * clampi(transform, 0, 120) + cl_idx);
        const bool dict_bad = is_dictref && !dict_ok;
        const int32_t adv = is_dictref ? dict_add : copy_len;
        const bool c_over = is_copy && !dict_bad && adv > mlen - out_len;

        const bool emit_cmd = block_end || (is_copy && !dict_bad && !c_over);
        if (emit_cmd) {
            int32_t* c = cmds + 3 * static_cast<int64_t>(
                                        clampi(ncmd, 0, s_cmd - 1));
            c[0] = cur_ins;
            c[1] = block_end ? 0 : copy_len;
            c[2] = block_end ? 0 : eff_dist;
        }
        ncmd += int32_t(emit_cmd);
        if (emit_cmd && !block_end) out_len += adv;

        // ring cache: push on explicit non-dictionary non-zero codes
        if (((is_dst && dd.dcode != 0) || (is_fdst && fd.dcode != 0)) &&
            !is_dictref && !c_over) {
            cache[3] = cache[2];
            cache[2] = cache[1];
            cache[1] = cache[0];
            cache[0] = eff_dist;
        }
        if (is_fdst) nbit += fd.bits;

        bad = bad || e_over || dict_bad || c_over || nlit > s_lit ||
              ncmd > s_cmd;
        const bool done_now = emit_cmd && out_len == mlen;
        int32_t nphase =
            (is_cmd && !fits)
                ? PH_EXTRAS
                : (ext_eff && !lit_done)
                      ? PH_LIT
                      : (lit_done && !block_end && impl == 0) ? PH_DIST
                                                              : phase;
        if (is_copy && !dict_bad && !c_over && !done_now) nphase = PH_CMD;
        if (done_now || block_end) nphase = PH_DONE;
        if (bad) nphase = PH_FALLBACK;
        phase = nphase;
        bit = nbit;
    }
    p.nlit[i] = nlit;
    p.ncmd[i] = ncmd;
    p.end_bit[i] = bit;
    p.status[i] = phase;
    for (int k = 0; k < 4; ++k) p.cache[4 * i + k] = cache[k];
    p.steps[i] = static_cast<int32_t>(step);
}

__global__ void __launch_bounds__(128)
step_probe_kernel(const int32_t* __restrict__ tab,
                  const int32_t* __restrict__ st, int32_t* __restrict__ out,
                  int lanes, int width, int steps, int reads) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int32_t* trow = tab + static_cast<int64_t>(lane) * width;
    uint32_t s = static_cast<uint32_t>(st[lane]);
    for (int k = 0; k < steps; ++k) {
        s = (s * 1103515245u + 12345u) & 0x3FFu;
        uint32_t acc = 0;
        for (int r = 0; r < reads; ++r)
            acc += static_cast<uint32_t>(__ldg(trow + s + r));
        s = (s + acc) & 0x3FFu;
    }
    out[lane] = static_cast<int32_t>(s);
}

}  // namespace

// Launches decode_step_kernel on `stream` (a cudaStream_t).  ptrs holds
// the kNumPtrs device pointers and sizes the 6 sizes of Params, in its
// field order (host arrays).  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does
// not take.
extern "C" int decode_step_launch(const int64_t* ptrs, const int64_t* sizes,
                                  int n_ptrs, void* stream) {
    if (n_ptrs != kNumPtrs) return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    int k = 0;
    auto next = [&]() { return reinterpret_cast<void*>(ptrs[k++]); };
    p.data = static_cast<const uint8_t*>(next());
    p.bit0 = static_cast<const int32_t*>(next());
    p.mlen = static_cast<const int32_t*>(next());
    p.window = static_cast<const int32_t*>(next());
    p.npostfix = static_cast<const int32_t*>(next());
    p.ndirect = static_cast<const int32_t*>(next());
    p.out_prefix = static_cast<const int32_t*>(next());
    p.cache0 = static_cast<const int32_t*>(next());
    p.table = static_cast<const int32_t*>(next());
    for (int t = 0; t < 3; ++t) {
        p.tree[t].first = static_cast<const int32_t*>(next());
        p.tree[t].limit = static_cast<const int32_t*>(next());
        p.tree[t].offset = static_cast<const int32_t*>(next());
        p.tree[t].syms = static_cast<const int32_t*>(next());
        p.tree[t].single = static_cast<const int32_t*>(next());
    }
    p.lits = static_cast<uint8_t*>(next());
    p.cmds = static_cast<int32_t*>(next());
    p.nlit = static_cast<int32_t*>(next());
    p.ncmd = static_cast<int32_t*>(next());
    p.end_bit = static_cast<int32_t*>(next());
    p.status = static_cast<int32_t*>(next());
    p.cache = static_cast<int32_t*>(next());
    p.steps = static_cast<int32_t*>(next());
    p.n = sizes[0];
    p.L = sizes[1];
    p.a_dist = sizes[2];
    p.max_steps = sizes[3];
    p.s_lit = sizes[4];
    p.s_cmd = sizes[5];
    if (p.n <= 0 || p.L <= 0 || p.a_dist < 1 || p.s_lit < 1 ||
        p.s_cmd < 1 || p.s_lit > INT32_MAX || p.s_cmd > INT32_MAX ||
        p.n > (int64_t(1) << 30))
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 32;
    const int64_t blocks = (p.n + threads - 1) / threads;
    decode_step_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// Launches step_probe_kernel on `stream`: tab int32 [lanes, width], st
// and out int32 [lanes] (device arrays), width >= 1024 + reads.
extern "C" int step_probe_launch(const void* tab, const void* st, void* out,
                                 int lanes, int width, int steps, int reads,
                                 void* stream) {
    if (lanes <= 0 || reads < 0 || width < 1024 + reads || steps < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 128;
    step_probe_kernel<<<(lanes + threads - 1) / threads, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tab), static_cast<const int32_t*>(st),
        static_cast<int32_t*>(out), lanes, width, steps, reads);
    return static_cast<int>(cudaGetLastError());
}
