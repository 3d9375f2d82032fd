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
// dependent chain (window -> symbol -> next window), so the kernel's
// time is the longest lane's steps times the latency of one step.  The
// design keeps every read of that chain on chip:
//
//   - each lane's root tables (ops/decode_gpu.py build_tree_lut: the
//     next LIT_BITS / CMD_BITS / DIST_BITS window bits -> symbol and
//     length, the command entry with its insert/copy codes and implicit
//     flag) and its trees' first/limit/offset rows are staged in shared
//     memory when the CTA starts, with the hot constants (insert and
//     copy length codes as base << 5 | extra bits, short distance codes,
//     dictionary size bits); a symbol is one shared read, and a code
//     longer than its table (0.5-2% of symbols) goes on with the
//     compare rule from the table's length + 1 and one global read
//   - the window comes from three aligned 8-byte words in registers;
//     a step consumes at most 57 bits, so it advances by at most one
//     word, and the word it then loads is needed a step later at the
//     earliest: the load is off the chain
//   - the distance ring is four registers, its short codes selected by
//     compares (no local memory)
//   - a step runs its phase's code only, and a step that cannot end in
//     a copy (a literal run that goes on, a command with an insert; most
//     steps) skips the copy and phase logic
//   - decode_step_plan (ops/decode_gpu.py) spreads the lanes over every
//     SM, one lane a warp: a warp runs only its own lane's phase
//
// step_probe_kernel is TPU probe #9's kernel function
// (research/decode_step_kernel_probe.py:61-82, launched at :94): per
// lane, `steps` iterations of an LCG step and READS (0-2) dependent
// reads from the lane's table row.  The TPU kernel holds the table in
// VMEM; here each warp stages its lane's row in shared memory with
// cp.async and its first thread runs the lane's chain on shared reads,
// the lanes spread over the SMs by ops/decode_gpu.py:step_probe_plan.
// READS is a template parameter, so a step is straight-line code.
// Bound: neither bytes nor operations but the latency of one step's
// dependent chain times the steps; latency_probe_kernel measures the
// dependent latency in cycles of each instruction on it (one thread,
// clock64 around loops of each).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int PH_CMD = 0, PH_EXTRAS = 1, PH_LIT = 2, PH_DIST = 3,
              PH_DONE = 4, PH_FALLBACK = 5;

// the constant table (ops/decode_gpu.py _TABLE_LAYOUT): its first
// HOT_INTS ints are staged in shared memory, the rest is read from
// global memory on the rare paths
constexpr int H_INS = 0, H_CPY = 24, H_SC_IDX = 48, H_SC_DELTA = 64,
              H_DICT_SBITS = 80, HOT_INTS = 128;
constexpr int T_CMD2INS = 128, T_CMD2CPY = 832, T_IMPL0 = 1536,
              T_DICT_OUTLEN = 2240;

// a lane's table (ops/decode_gpu.py lane_tables): the root tables, then
// each tree's rows first[16], limit[16], offset[16]
constexpr int LIT_BITS = 9, CMD_BITS = 10, DIST_BITS = 8;
constexpr int LUT_LONG = 1 << 4;
constexpr int L_LIT = 0, L_CMD = L_LIT + (1 << LIT_BITS),
              L_DIST = L_CMD + (1 << CMD_BITS),
              L_ROWS = L_DIST + (1 << DIST_BITS), ROW_INTS = 48,
              LANE_INTS = L_ROWS + 3 * ROW_INTS;
static_assert(LANE_INTS % 4 == 0, "a lane's table is staged as int4");

constexpr int MAX_THREADS = 256;       // decode_gpu.PLAN_MAX_WARPS warps
constexpr int MAX_SMEM = 232448;       // an H100 CTA's dynamic shared bytes

// Field order = the pointer and size arrays decode_step_launch takes.
struct Params {
    const uint8_t* data;  // [N, L]: rows padded by the wrapper, L % 16 == 0
    const int32_t *bit0, *mlen, *window, *npostfix, *ndirect, *out_prefix;
    const int32_t* cache0;    // [N, 4]
    const int32_t* table;     // the constant table
    const int32_t* lane_tab;  // [N, LANE_INTS]
    const int32_t* syms[3];   // literal, command, distance: [N, A]
    uint8_t* lits;            // [N, s_lit]
    int32_t* cmds;            // [N, s_cmd, 3]
    int32_t *nlit, *ncmd, *end_bit, *status;
    int32_t* cache;  // [N, 4]
    int32_t* steps;  // [N]
    int64_t n, L, a_dist, max_steps, s_lit, s_cmd;
    int32_t lanes_per_cta;  // one lane a warp
};
constexpr int kNumPtrs = 21, kNumSizes = 9;

struct LaneTree {
    const int32_t* lut;   // shared: the root table
    const int32_t* rows;  // shared: first[16], limit[16], offset[16]
    const int32_t* syms;  // global: the lane's symbols by (length, symbol)
    int32_t a;
};

__device__ __forceinline__ int32_t clampi(int32_t v, int32_t lo,
                                          int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
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

// One symbol from the low 15 bits of w as the root-table entry
// (length | sym << 5, and for the command tree the codes of
// build_tree_lut).  An entry marked LUT_LONG goes on with
// ops/decode_gpu.py:_tree_decode's rule from length BITS + 1 (no
// shorter code matched: the table says so): the first length whose
// candidate lies in [first, limit); none found is "bad" and still reads
// the length-1 slot, as the plain version's argmax of an all-false row
// does.  A one-symbol tree's table gives the symbol with 0 bits.
template <int BITS, bool CMD>
__device__ __forceinline__ int32_t tree_decode(const LaneTree& t,
                                               const int32_t* tab,
                                               uint32_t w, bool& bad) {
    int32_t e = t.lut[w & ((1u << BITS) - 1u)];
    bad = false;
    if (e & LUT_LONG) {
        const int32_t r = bitrev15(w & 0x7FFFu);
        int l = BITS;
        bool found = false;
        for (; l < 15; ++l) {
            const int32_t c = r >> (14 - l);
            if (c < t.rows[16 + l] && c >= t.rows[l]) {
                found = true;
                break;
            }
        }
        if (!found) l = 0;
        const int32_t c = r >> (14 - l);
        const int32_t sym = __ldg(t.syms + clampi(t.rows[32 + l] + c -
                                                  t.rows[l], 0, t.a - 1));
        e = (l + 1) | (sym << 5);
        if constexpr (CMD) {
            const int32_t s = clampi(sym, 0, 703);
            e |= (__ldg(tab + T_IMPL0 + s) << 15) |
                 (__ldg(tab + T_CMD2INS + s) << 16) |
                 (__ldg(tab + T_CMD2CPY + s) << 21);
        }
        bad = !found;
    }
    return e;
}

struct Dist {
    int32_t d, bits, dcode;
    bool bad;
};

// Distance symbol + short-code / direct / extra bits, from the window w
// (decode_tpu.py dist_decode); the ring is c0..c3, newest first.
__device__ __forceinline__ Dist dist_decode(const LaneTree& t,
                                            const int32_t* hot, int32_t c0,
                                            int32_t c1, int32_t c2,
                                            int32_t c3, int32_t npostfix,
                                            int32_t ndirect, uint64_t w) {
    bool d_bad;
    const int32_t e = tree_decode<DIST_BITS, false>(
        t, nullptr, static_cast<uint32_t>(w), d_bad);
    const int32_t d_bits0 = e & 15;
    const int32_t dcode = clampi(e >> 5, 0, t.a - 1);
    const int32_t d15 = clampi(dcode, 0, 15);
    const int32_t idx = clampi(hot[H_SC_IDX + d15], 0, 3);
    const int32_t ring = idx == 0 ? c0 : (idx == 1 ? c1 : (idx == 2 ? c2
                                                                    : c3));
    const int32_t short_d = ring + hot[H_SC_DELTA + d15];
    const int32_t direct_d = dcode - 16 + 1;
    const int32_t h = max(dcode - ndirect - 16, 0);
    const int32_t hcode = h >> npostfix;
    const int32_t lcode = h & ((1 << npostfix) - 1);
    const int32_t nbits_raw = 1 + (hcode >> 1);
    const int32_t nbits = clampi(nbits_raw, 0, 24);  // > 24 is malformed
    const int32_t offs = ((2 + (hcode & 1)) << nbits) - 4;
    const int32_t extra = static_cast<int32_t>(
        mask(static_cast<uint32_t>(w >> d_bits0), nbits));
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

__global__ void __launch_bounds__(MAX_THREADS, 1)
decode_step_kernel(const Params p) {
    extern __shared__ int4 smem[];
    const int32_t* hot = reinterpret_cast<const int32_t*>(smem);
    const int64_t lane0 = static_cast<int64_t>(blockIdx.x) * p.lanes_per_cta;
    const int64_t left = p.n - lane0;
    const int nl = left < p.lanes_per_cta ? static_cast<int>(left)
                                          : p.lanes_per_cta;
    // stage the hot constants and the CTA's lanes' tables, 16 bytes a
    // thread (every thread of the CTA, lanes or not)
    {
        const int4* src = reinterpret_cast<const int4*>(p.table);
        for (int k = threadIdx.x; k < HOT_INTS / 4; k += blockDim.x)
            smem[k] = __ldg(src + k);
        src = reinterpret_cast<const int4*>(p.lane_tab + lane0 * LANE_INTS);
        for (int k = threadIdx.x; k < nl * (LANE_INTS / 4); k += blockDim.x)
            smem[HOT_INTS / 4 + k] = __ldg(src + k);
    }
    __syncthreads();
    // one lane a warp, on its lane 0: a warp runs its own lane's phase
    const int slot = threadIdx.x >> 5;
    if ((threadIdx.x & 31) != 0 || slot >= nl) return;
    const int64_t i = lane0 + slot;

    const int32_t* tab = p.table;
    // the lane's table offset, opaque so that the compiler keeps it in
    // a register and does not rebuild it from the thread index
    int32_t lt_off = HOT_INTS + slot * LANE_INTS;
    asm volatile("" : "+r"(lt_off));
    const int32_t* lt = hot + lt_off;
    const int32_t a_dist = static_cast<int32_t>(p.a_dist);
    const LaneTree lit{lt + L_LIT, lt + L_ROWS, p.syms[0] + 256 * i, 256};
    const LaneTree cmd{lt + L_CMD, lt + L_ROWS + ROW_INTS,
                       p.syms[1] + 704 * i, 704};
    const LaneTree dst{lt + L_DIST, lt + L_ROWS + 2 * ROW_INTS,
                       p.syms[2] + a_dist * i, a_dist};
    const int32_t mlen = p.mlen[i], window = p.window[i];
    const int32_t npostfix = p.npostfix[i], ndirect = p.ndirect[i];
    const int32_t out_prefix = p.out_prefix[i];
    const int32_t s_lit = static_cast<int32_t>(p.s_lit);
    const int32_t s_cmd = static_cast<int32_t>(p.s_cmd);
    uint8_t* lits = p.lits + i * p.s_lit;
    int32_t* cmds = p.cmds + i * p.s_cmd * 3;
    // opaque, so that the compiler keeps the two pointers in registers
    // and does not rebuild them from the parameters at every store
    asm volatile("" : "+l"(lits), "+l"(cmds));

    // The row as aligned 8-byte words, the index clamped to the row's
    // last word.  The wrapper pads each row to L >= its length + 7 with
    // copies of its last byte (decode_gpu._padded_rows), so that last
    // word holds only such copies: every byte past the batch's row
    // length reads as its last byte, as the plain version's clamp gives.
    const uint64_t* row = reinterpret_cast<const uint64_t*>(p.data + i * p.L);
    const int32_t wlast = static_cast<int32_t>(p.L / 8 - 1);
    int32_t bit = p.bit0[i];
    // the words wb, wb + 1, wb + 2 of the row; bit - 64 wb is in [0, 64)
    int32_t wb = bit >> 6;
    uint64_t q0 = __ldg(row + min(wb, wlast));
    uint64_t q1 = __ldg(row + min(wb + 1, wlast));
    uint64_t q2 = __ldg(row + min(wb + 2, wlast));

    int32_t phase = PH_CMD, out_len = 0;
    int32_t ins_code = 0, cpy_code = 0, ins_rem = 0, cur_ins = 0;
    int32_t copy_len = 0, impl = 0, nlit = 0, ncmd = 0;
    int32_t c0 = p.cache0[4 * i], c1 = p.cache0[4 * i + 1];
    int32_t c2 = p.cache0[4 * i + 2], c3 = p.cache0[4 * i + 3];

    // moves to bit `nbit`; a step consumes at most 57 bits, so at most
    // one word is used up, and the word then loaded is needed one step
    // later at the earliest
    auto advance = [&](int32_t nbit) {
        bit = nbit;
        if ((nbit >> 6) > wb) {
            ++wb;
            q0 = q1;
            q1 = q2;
            q2 = __ldg(row + min(wb + 2, wlast));
        }
    };

    int64_t step = 0;
    for (; step < p.max_steps && phase < PH_DONE; ++step) {
        // 64-bit window at `bit`, its top (bit & 7) bits 0 as the byte
        // window of the plain version leaves them
        const uint32_t off = static_cast<uint32_t>(bit - (wb << 6));
        uint64_t w = off ? (q0 >> off) | (q1 << (64u - off)) : q0;
        w &= ~0ull >> (bit & 7);
        const uint32_t w_lo = static_cast<uint32_t>(w);

        // The lane's phase.  A step that cannot end in a copy (literals
        // of the command are left, the command's extras did not fit or
        // its insert is not done) moves only the position, the counts
        // and the phase, and ends here; the others (the last literals
        // of a command, a command with no insert, a DIST step) go on to
        // the copy below.
        int32_t nbit, f_off = 0;
        bool bad, e_over = false, is_dst = false;
        Dist dd{0, 0, 0, false};
        if (phase == PH_LIT) {
            // up to 3 literals from one window (writes clipped, in order)
            bool b;
            int32_t e = tree_decode<LIT_BITS, false>(lit, tab, w_lo, b);
            lits[clampi(nlit, 0, s_lit - 1)] = static_cast<uint8_t>(e >> 5);
            int32_t lit_bits = e & 15, nl_step = 1;
            bad = b;
            if (ins_rem >= 2) {
                e = tree_decode<LIT_BITS, false>(
                    lit, tab, static_cast<uint32_t>(w >> lit_bits), b);
                lits[clampi(nlit + 1, 0, s_lit - 1)] =
                    static_cast<uint8_t>(e >> 5);
                lit_bits += e & 15;
                bad = bad || b;
                nl_step = 2;
                if (ins_rem >= 3) {
                    e = tree_decode<LIT_BITS, false>(
                        lit, tab, static_cast<uint32_t>(w >> lit_bits), b);
                    lits[clampi(nlit + 2, 0, s_lit - 1)] =
                        static_cast<uint8_t>(e >> 5);
                    lit_bits += e & 15;
                    bad = bad || b;
                    nl_step = 3;
                }
            }
            nlit += nl_step;
            out_len += nl_step;
            ins_rem -= nl_step;
            nbit = bit + lit_bits;
            if (ins_rem != 0) {
                phase = (bad || nlit > s_lit || ncmd > s_cmd) ? PH_FALLBACK
                                                              : PH_LIT;
                advance(nbit);
                continue;
            }
            f_off = lit_bits;
        } else if (phase == PH_DIST) {
            dd = dist_decode(dst, hot, c0, c1, c2, c3, npostfix, ndirect, w);
            nbit = bit + dd.bits;
            bad = dd.bad;
            is_dst = true;
        } else {
            // command symbol, extras fused when they fit; or the extras
            // alone
            const bool is_cmd = phase == PH_CMD;
            int32_t c_bits = 0;
            bad = false;
            if (is_cmd) {
                const int32_t e =
                    tree_decode<CMD_BITS, true>(cmd, tab, w_lo, bad);
                c_bits = e & 15;
                impl = (e >> 15) & 1;
                ins_code = (e >> 16) & 31;
                cpy_code = (e >> 21) & 31;
            }
            const int32_t ip = hot[H_INS + ins_code];
            const int32_t cp = hot[H_CPY + cpy_code];
            const int32_t iebits = ip & 31, cebits = cp & 31;
            const int32_t e_bits = iebits + cebits;
            const bool ext_eff = !is_cmd || c_bits + e_bits <= 57;
            nbit = bit + c_bits + (ext_eff ? e_bits : 0);
            if (ext_eff) {
                const int32_t e_ins_len = (ip >> 5) + static_cast<int32_t>(
                    mask(static_cast<uint32_t>(w >> c_bits), iebits));
                e_over = e_ins_len > mlen - out_len;
                ins_rem = e_ins_len;
                cur_ins = e_ins_len;
                copy_len = (cp >> 5) + static_cast<int32_t>(mask(
                    static_cast<uint32_t>(w >> (c_bits + iebits)), cebits));
            }
            if (!(ext_eff && !e_over && ins_rem == 0)) {
                bad = bad || e_over || nlit > s_lit || ncmd > s_cmd;
                phase = bad ? PH_FALLBACK : (ext_eff ? PH_LIT : PH_EXTRAS);
                advance(nbit);
                continue;
            }
            f_off = c_bits + e_bits;
        }

        // the copy: the command's literals are all out, or a DIST step
        const bool lit_done = !is_dst;
        const bool block_end = lit_done && out_len == mlen;
        const bool use_impl = lit_done && !block_end && impl == 1;

        // the distance fused into this step, where the window covers it
        // (past 42 bits in it never fuses, so it is not decoded)
        const bool want_f = lit_done && !block_end && impl == 0;
        bool is_fdst = false;
        Dist fd{0, 0, 0, false};
        if (want_f && f_off <= 42) {
            fd = dist_decode(dst, hot, c0, c1, c2, c3, npostfix, ndirect,
                             w >> f_off);
            is_fdst = !fd.bad && f_off + fd.bits <= 57;
        }
        const int32_t max_dist = min(out_len + out_prefix, window);

        // copy: implicit, fused or DIST step; past max_dist it is a
        // static-dictionary word of the transform's output length
        const bool is_copy = use_impl || is_dst || is_fdst;
        const int32_t eff_dist = is_dst ? dd.d : (is_fdst ? fd.d : c0);
        const bool is_dictref = is_copy && eff_dist > max_dist;
        int32_t adv = copy_len;
        bool dict_bad = false;
        if (is_dictref) {
            const int32_t word_id = eff_dist - max_dist - 1;
            const bool cl_ok = copy_len >= 4 && copy_len <= 24;
            const int32_t cl_idx = clampi(copy_len, 0, 24);
            const int32_t sb = hot[H_DICT_SBITS + cl_idx];
            const int32_t transform = sb < 31 ? (word_id >> sb) : 121;
            dict_bad = !(cl_ok && transform < 121 && word_id >= 0);
            adv = __ldg(tab + T_DICT_OUTLEN +
                        25 * clampi(transform, 0, 120) + cl_idx);
        }
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
            c3 = c2;
            c2 = c1;
            c1 = c0;
            c0 = eff_dist;
        }
        if (is_fdst) nbit += fd.bits;

        bad = bad || dict_bad || c_over || nlit > s_lit || ncmd > s_cmd;
        const bool done_now = emit_cmd && out_len == mlen;
        int32_t nphase = want_f ? PH_DIST : phase;
        if (is_copy && !dict_bad && !c_over && !done_now) nphase = PH_CMD;
        if (done_now || block_end) nphase = PH_DONE;
        if (bad) nphase = PH_FALLBACK;
        phase = nphase;
        advance(nbit);
    }
    p.nlit[i] = nlit;
    p.ncmd[i] = ncmd;
    p.end_bit[i] = bit;
    p.status[i] = phase;
    p.cache[4 * i] = c0;
    p.cache[4 * i + 1] = c1;
    p.cache[4 * i + 2] = c2;
    p.cache[4 * i + 3] = c3;
    p.steps[i] = static_cast<int32_t>(step);
}

constexpr int PROBE_MAX_LANES = 8;     // decode_gpu.PROBE_MAX_LANES
constexpr int PROBE_ROW_ALIGN = 4096;  // decode_gpu.PROBE_ROW_ALIGN

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool wide) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if (wide)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
                     "l"(gmem));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
                     "l"(gmem));
}

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
    return v;
}

// Each lane's row starts on a PROBE_ROW_ALIGN-byte boundary of the
// shared window (ops/decode_gpu.py:step_probe_plan counts the slack),
// and the chain carries u = 4 s: the address of row[(s a + c) & 0x3FF] is
// then ((u a + 4 c) & 0xFFC) | row, one LOP3, and the next u is that
// address plus 4 acc (its row bits vanish mod 4096 in the next
// multiply).  A step is IMAD, LOP3, LDS (two issue together), an add of
// two reads and an IMAD that adds 4 acc to the address; with no read,
// one IMAD, which the compiler folds four steps at a time
// (ops/decode_gpu.py:step_latency_path).
template <int READS>
__global__ void __launch_bounds__(32 * PROBE_MAX_LANES)
step_probe_kernel(const int32_t* __restrict__ tab,
                  const int32_t* __restrict__ st, int32_t* __restrict__ out,
                  int lanes, int width, int steps, int per_cta) {
    extern __shared__ int4 smem[];
    const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
    const int lane = blockIdx.x * per_cta + w;
    if (lane >= lanes) return;
    const uint32_t win =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const uint32_t stride =
        (4u * width + PROBE_ROW_ALIGN - 1) & ~(PROBE_ROW_ALIGN - 1u);
    const uint32_t row = ((win + PROBE_ROW_ALIGN - 1) &
                          ~(PROBE_ROW_ALIGN - 1u)) + w * stride;
    if (READS > 0) {
        // the warp stages its lane's row
        char* dst = reinterpret_cast<char*>(smem) + (row - win);
        const int32_t* src = tab + static_cast<int64_t>(lane) * width;
        const int head =
            (reinterpret_cast<uintptr_t>(src) & 15) == 0 ? width & ~3 : 0;
        for (int q = 4 * t; q < head; q += 128)
            cp_async(dst + 4 * q, src + q, true);
        for (int q = head + t; q < width; q += 32)
            cp_async(dst + 4 * q, src + q, false);
        asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                         : "memory");
        __syncwarp();
    }
    if (t != 0) return;
    const uint32_t s0 = static_cast<uint32_t>(st[lane]);
    if (steps == 0) {
        out[lane] = static_cast<int32_t>(s0);
        return;
    }
    uint32_t u = s0 << 2;
    for (int k = 0; k < steps; ++k) {
        const uint32_t x = u * 1103515245u + 4u * 12345u;
        if (READS == 0) {
            u = x;
            continue;
        }
        const uint32_t a = (x & 0xFFCu) | row;
        uint32_t acc = lds(a);
        if (READS == 2) acc += lds(a + 4);
        u = a + (acc << 2);
    }
    out[lane] = static_cast<int32_t>((u >> 2) & 0x3FFu);
}

// One thread: for each instruction kind, clock64 around a loop of
// `iters` trips of LAT_UNROLL dependent instructions of that kind, at
// two trip counts; cycles[2 * kind + c] the clocks of the short (c = 0)
// and the long loop (kinds: IMAD, LOP3, IADD3 + LOP3 pairs, LDS).  The
// loop keeps the clock reads on either side of the chain, and the chain
// goes on from one timing to the next, so no two chains compute the
// same.  in holds five words the compiler cannot see; sink takes the
// chain's end.
constexpr int LAT_UNROLL = 64, LAT_KINDS = 4;

template <int KIND>
__device__ __forceinline__ uint32_t lat_chain(uint32_t x, const uint32_t* v) {
#pragma unroll
    for (int k = 0; k < LAT_UNROLL; ++k) {
        if (KIND == 0) {
            asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x)
                         : "r"(v[1]), "r"(v[2]));
        } else if (KIND == 1) {
            asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(x)
                         : "r"(v[1 + (k & 3)]), "r"(v[1 + ((k + 1) & 3)]));
        } else if (KIND == 2) {
            asm volatile("add.u32 %0, %0, %1;" : "+r"(x) : "r"(v[1]));
            asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;" : "+r"(x)
                         : "r"(v[1 + (k & 3)]), "r"(v[1 + ((k + 1) & 3)]));
        } else {
            asm volatile("ld.volatile.shared.u32 %0, [%0];" : "+r"(x));
        }
    }
    return x;
}

template <int KIND>
__device__ __noinline__ uint32_t lat_kind(uint32_t x, const uint32_t* v,
                                          int iters_short, int iters_long,
                                          long long* cycles) {
    for (int rep = 0; rep < 2; ++rep) {   // the first pass warms the code
        for (int c = 0; c < 2; ++c) {
            const int iters = c ? iters_long : iters_short;
            const long long t0 = clock64();
            for (int it = 0; it < iters; ++it) x = lat_chain<KIND>(x, v);
            const long long t1 = clock64();
            cycles[2 * KIND + c] = t1 - t0;
        }
    }
    return x;
}

__global__ void latency_probe_kernel(const uint32_t* __restrict__ in,
                                     int iters_short, int iters_long,
                                     long long* __restrict__ cycles,
                                     uint32_t* __restrict__ sink) {
    __shared__ uint32_t self;
    uint32_t v[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) v[k] = in[k];
    // the shared word holds its own address: a chase stays on it
    const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(&self));
    self = at;
    __syncwarp();
    sink[0] = lat_kind<0>(v[0], v, iters_short, iters_long, cycles);
    sink[1] = lat_kind<1>(v[0], v, iters_short, iters_long, cycles);
    sink[2] = lat_kind<2>(v[0], v, iters_short, iters_long, cycles);
    sink[3] = lat_kind<3>(at, v, iters_short, iters_long, cycles);
}

}  // namespace

// Launches decode_step_kernel on `stream` (a cudaStream_t).  ptrs holds
// the kNumPtrs device pointers and sizes the kNumSizes sizes of Params,
// in its field order (host arrays), then the plan of
// ops/decode_gpu.py:decode_step_plan: lanes (= warps) a CTA, CTAs,
// dynamic shared bytes.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int decode_step_launch(const int64_t* ptrs, const int64_t* sizes,
                                  int n_ptrs, int n_sizes, void* stream) {
    if (n_ptrs != kNumPtrs || n_sizes != kNumSizes)
        return static_cast<int>(cudaErrorInvalidValue);
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
    p.lane_tab = static_cast<const int32_t*>(next());
    for (int t = 0; t < 3; ++t)
        p.syms[t] = static_cast<const int32_t*>(next());
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
    const int64_t per_cta = sizes[6], ctas = sizes[7], smem = sizes[8];
    const bool aligned =
        (reinterpret_cast<uintptr_t>(p.data) | reinterpret_cast<uintptr_t>(
             p.table) | reinterpret_cast<uintptr_t>(p.lane_tab)) % 16 == 0;
    if (p.n <= 0 || p.L < 16 || p.L % 16 || p.L > (int64_t(1) << 28) ||
        p.a_dist < 1 || p.s_lit < 1 || p.s_cmd < 1 ||
        p.s_lit > INT32_MAX || p.s_cmd > INT32_MAX ||
        p.n > (int64_t(1) << 30) || !aligned || per_cta < 1 ||
        per_cta * 32 > MAX_THREADS || ctas * per_cta < p.n ||
        (ctas - 1) * per_cta >= p.n ||
        smem != 4 * (HOT_INTS + per_cta * LANE_INTS) || smem > MAX_SMEM)
        return static_cast<int>(cudaErrorInvalidValue);
    p.lanes_per_cta = static_cast<int32_t>(per_cta);
    cudaError_t err = cudaFuncSetAttribute(
        decode_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    decode_step_kernel<<<static_cast<unsigned>(ctas),
                         static_cast<unsigned>(per_cta * 32),
                         static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int READS>
cudaError_t launch_probe(const void* tab, const void* st, void* out,
                         int lanes, int width, int steps, int per_cta,
                         int ctas, int smem, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(
        step_probe_kernel<READS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    step_probe_kernel<READS><<<ctas, 32 * per_cta, smem, stream>>>(
        static_cast<const int32_t*>(tab), static_cast<const int32_t*>(st),
        static_cast<int32_t*>(out), lanes, width, steps, per_cta);
    return cudaGetLastError();
}

// Launches step_probe_kernel<reads> on `stream`: tab int32 [lanes,
// width], st and out int32 [lanes] (device arrays), width >= 1024 +
// reads, reads 0, 1 or 2; per_cta (lanes a CTA), ctas and smem (dynamic
// shared bytes) are ops/decode_gpu.py:step_probe_plan's.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments or a plan the kernel does not take.
extern "C" int step_probe_launch(const void* tab, const void* st, void* out,
                                 int lanes, int width, int steps, int reads,
                                 int per_cta, int ctas, int smem,
                                 void* stream) {
    if (lanes <= 0 || reads < 0 || reads > 2 || width < 1024 + reads ||
        steps < 0 || per_cta < 1 || per_cta > PROBE_MAX_LANES ||
        static_cast<int64_t>(ctas) * per_cta < lanes ||
        static_cast<int64_t>(ctas - 1) * per_cta >= lanes ||
        smem != PROBE_ROW_ALIGN + static_cast<int64_t>(per_cta) *
                    ((4 * width + PROBE_ROW_ALIGN - 1) / PROBE_ROW_ALIGN) *
                    PROBE_ROW_ALIGN ||
        smem > MAX_SMEM)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = reads == 0
        ? launch_probe<0>(tab, st, out, lanes, width, steps, per_cta, ctas,
                          smem, s)
        : reads == 1
        ? launch_probe<1>(tab, st, out, lanes, width, steps, per_cta, ctas,
                          smem, s)
        : launch_probe<2>(tab, st, out, lanes, width, steps, per_cta, ctas,
                          smem, s);
    return static_cast<int>(e);
}

// Launches latency_probe_kernel (one thread) on `stream`: in uint32
// [5], cycles int64 [2 * LAT_KINDS], sink uint32 [LAT_KINDS] (device
// arrays); each timing runs iters_short and iters_long loop trips of
// LAT_UNROLL instructions.
extern "C" int latency_probe_launch(const void* in, int iters_short,
                                    int iters_long, void* cycles, void* sink,
                                    void* stream) {
    if (iters_short < 1 || iters_long <= iters_short)
        return static_cast<int>(cudaErrorInvalidValue);
    latency_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(in), iters_short, iters_long,
        static_cast<long long*>(cycles), static_cast<uint32_t*>(sink));
    return static_cast<int>(cudaGetLastError());
}

// The SM clock of `device` in kHz (cudaDevAttrClockRate, the clock
// cudaDeviceProp.clockRate gives), or 0 where the attribute fails.
extern "C" int sm_clock_khz(int device) {
    int khz = 0;
    if (cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, device) !=
        cudaSuccess)
        return 0;
    return khz;
}
