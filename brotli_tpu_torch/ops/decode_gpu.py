"""Batched symbol-layer decode: CUDA kernels + wrappers.

Counterpart of brotli_tpu/ops/decode_tpu.py.  N independent compressed
metablocks (one per lane) decode their entropy layer on the device:
canonical prefix trees built from the wire's code lengths, then the
command / literal / distance symbol loop with extra bits, the distance
ring and the exact output length, including static-dictionary
references (advanced by the transform's output length; the host
resolves the bytes).  The host keeps the header walk before and the LZ
execution after (decode/batch_gpu.py).

`batch_decode_device` builds the trees with torch ops and, on CUDA
tensors, each lane's Huffman root tables (`build_tree_lut`) and the
launch grid (`decode_step_plan`), and launches the per-lane step loop
in csrc/decode_step.cu (built with nvcc for sm_90a at first use,
loaded with ctypes); on CPU tensors
it runs the plain PyTorch version `batch_decode_ref`, which advances
every live lane by one step per iteration exactly as the JAX package's
`lax.while_loop` body does.  `step_probe` is the exact function of the
TPU probe research/decode_step_kernel_probe.py's Pallas kernel, with
`step_probe_ref` beside it, on the grid of `step_probe_plan`, and
`latency_probe` measures the dependent latency of the instructions on
its chain.  LAUNCHES counts kernel launches under "decode_step",
"step_probe" and, by read count, "step_probe_reads<r>"; LAST_PLAN holds
the grid of the last decode_step launch, LAST_PROBE_PLAN that of the
last step_probe launch.

Unsigned 32-bit bit windows are carried in int64 with & 0xFFFFFFFF in
the plain version (torch has no uint32 shifts on the CPU); lane state
is int64 there and int32 in the kernel, and no value of it leaves the
int32 range, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..buildcache import CudaLibrary
from ..core import constants as C

# phases
PH_CMD = 0
PH_EXTRAS = 1
PH_LIT = 2
PH_DIST = 3
PH_DONE = 4
PH_FALLBACK = 5

M32 = 0xFFFFFFFF
# the plain loop checks for live lanes every this many steps (a step of
# a lane that is no longer live changes nothing)
_CHECK_EVERY = 16

#: kernel launches, under "decode_step", "step_probe" and
#: "step_probe_reads<r>"; reset and read by callers that check a run
#: went through the kernels
LAUNCHES: dict[str, int] = {}
#: decode_step_plan's grid of the last decode_step launch, with its
#: lane count under "lanes"
LAST_PLAN: dict = {}
#: step_probe_plan's grid of the last step_probe launch, with its lanes,
#: width and reads
LAST_PROBE_PLAN: dict = {}


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.decode_step_launch.argtypes = [vp, vp, ci, ci, vp]
    lib.decode_step_launch.restype = ci
    lib.step_probe_launch.argtypes = [vp, vp, vp] + [ci] * 7 + [vp]
    lib.step_probe_launch.restype = ci
    lib.latency_probe_launch.argtypes = [vp, ci, ci, vp, vp, vp]
    lib.latency_probe_launch.restype = ci
    lib.sm_clock_khz.argtypes = [ci]
    lib.sm_clock_khz.restype = ci


LIB = CudaLibrary("decode_step", _bind)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _dict_len_tables():
    """size_bits per word length (31 = invalid) and the transform's
    OUTPUT length per (transform, word length): content-independent,
    since omit counts and prefix/suffix lengths are fixed and ferment
    keeps the length (RFC 7932 section 8)."""
    from ..core.dictionary import apply_transform, get_dictionary
    d = get_dictionary()
    sbits = np.full(25, 31, np.int32)
    outlen = np.zeros((121, 25), np.int32)
    for length in range(4, 25):
        sbits[length] = int(d.size_bits_by_length[length])
        for t in range(121):
            outlen[t, length] = len(apply_transform(d, b"a" * length, t))
    return sbits, outlen


# the kernel's constant table: (name, length) in the order of
# csrc/decode_step.cu's T_* offsets.  Its first HOT_INTS entries are
# what a step reads, staged in each CTA's shared memory: the insert and
# copy length codes packed as base << 5 | extra bits, the short
# distance codes and the dictionary's size bits.  The rest is read from
# global memory on the rare paths (a command code longer than its root
# table, a static-dictionary reference).
_TABLE_LAYOUT = [("ins_pack", 24), ("cpy_pack", 24), ("sc_idx", 16),
                 ("sc_delta", 16), ("dict_sbits", 25), ("hot_pad", 23),
                 ("cmd2ins", 704), ("cmd2cpy", 704), ("implicit0", 704),
                 ("dict_outlen", 121 * 25)]
HOT_INTS = 128


def _tables_np() -> dict[str, np.ndarray]:
    sbits, outlen = _dict_len_tables()
    return dict(
        ins_base=C.INSERT_BASE, ins_extra=C.INSERT_EXTRA,
        cpy_base=C.COPY_BASE, cpy_extra=C.COPY_EXTRA,
        cmd2ins=C.CMD_TO_INSERT_CODE, cmd2cpy=C.CMD_TO_COPY_CODE,
        implicit0=C.CMD_IMPLICIT_DIST0.astype(np.int64),
        sc_idx=C.DISTANCE_SHORT_CODE_INDEX,
        sc_delta=C.DISTANCE_SHORT_CODE_DELTA,
        dict_sbits=sbits, dict_outlen=outlen.ravel())


@functools.lru_cache(maxsize=None)
def _kernel_table(dev: torch.device) -> torch.Tensor:
    """The constant tables as one int32 array on `dev`."""
    t = _tables_np()
    t["ins_pack"] = (np.asarray(t["ins_base"], np.int64) << 5) \
        | t["ins_extra"]
    t["cpy_pack"] = (np.asarray(t["cpy_base"], np.int64) << 5) \
        | t["cpy_extra"]
    t["hot_pad"] = np.zeros(23, np.int64)
    parts = []
    for name, n in _TABLE_LAYOUT:
        if len(t[name]) != n:
            raise RuntimeError(f"decode table {name} has {len(t[name])} "
                               f"entries, want {n}")
        parts.append(np.asarray(t[name], np.int32))
    if sum(n for _, n in _TABLE_LAYOUT[:6]) != HOT_INTS:
        raise RuntimeError("decode table: the hot part is not HOT_INTS")
    return torch.from_numpy(np.concatenate(parts)).to(dev)


# ---------------------------------------------------------------------------
# Canonical trees (torch ops on the lanes' device)
# ---------------------------------------------------------------------------


def _bitrev15(x):
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return (x >> 1) & 0x7FFF  # 16-bit reverse -> 15-bit


def build_tree_device(lengths: torch.Tensor) -> dict[str, torch.Tensor]:
    """Canonical decode rows from per-symbol code lengths.

    lengths: [N, A] integer (0 = absent).  Returns int32 first / limit /
    offset [N, 15] (per code length 1..15), syms [N, A] (symbols sorted
    by (length, symbol)), single [N] (the symbol if the tree has exactly
    one, else -1)."""
    n, a = lengths.shape
    dev = lengths.device
    lengths = lengths.long()
    ls = torch.arange(1, 16, device=dev)
    count = (lengths[:, None, :] == ls[None, :, None]).sum(2)   # [N, 15]
    firsts = []
    code = torch.zeros(n, dtype=torch.int64, device=dev)
    prev = torch.zeros(n, dtype=torch.int64, device=dev)
    for i in range(15):
        code = (code + prev) << 1
        firsts.append(code)
        prev = count[:, i]
    first = torch.stack(firsts, dim=1)
    limit = first + count
    offset = torch.cumsum(count, dim=1) - count
    key = torch.where(lengths > 0, lengths, 99) * (2 * a) \
        + torch.arange(a, device=dev)[None, :]
    order = torch.argsort(key, dim=1, stable=True)
    present = (lengths > 0).to(torch.int32)
    nz = present.sum(1)
    single_sym = torch.argmax(present, dim=1)   # first present symbol
    single = torch.where(nz == 1, single_sym, -1)
    i32 = torch.int32
    return dict(first=first.to(i32), limit=limit.to(i32),
                offset=offset.to(i32), syms=order.to(i32),
                single=single.to(i32))


def _tree_decode(tree, w_lo):
    """Decode one symbol per lane from the low bits of w_lo (int64
    holding u32).  Returns (symbol, bits consumed, bad)."""
    peek = w_lo & 0x7FFF
    r = _bitrev15(peek)
    shifts = 14 - torch.arange(15, device=w_lo.device)
    cand = r[:, None] >> shifts[None, :]                     # [N, 15]
    first = tree["first"]
    ok = (cand < tree["limit"]) & (cand >= first)
    l_idx = torch.argmax(ok.to(torch.int32), dim=1)          # first True
    li = l_idx[:, None]
    c = cand.gather(1, li)[:, 0]
    pos = tree["offset"].gather(1, li)[:, 0] + c - first.gather(1, li)[:, 0]
    pos = pos.clamp(0, tree["syms"].shape[1] - 1)
    sym = tree["syms"].gather(1, pos[:, None])[:, 0]
    nbits = l_idx + 1
    bad = ~ok.any(1)
    sgl = tree["single"]
    sym = torch.where(sgl >= 0, sgl, sym)
    nbits = torch.where(sgl >= 0, 0, nbits)
    bad = torch.where(sgl >= 0, False, bad)
    return sym, nbits, bad


# ---------------------------------------------------------------------------
# Root tables: what the kernel reads in place of the 15-length compare
# ---------------------------------------------------------------------------

#: root-table bits of the literal, command and distance trees.  On the
#: serving batch's lanes codes longer than these carry about 0.5%, 2%
#: and 0.5% of the symbols (research/root_bits.py); a longer table costs
#: shared memory and staging, a shorter one the long-code rule more
#: often.
LUT_BITS = (9, 10, 8)
#: an entry's flag: no code of at most the table's bits matches
LUT_LONG = 1 << 4
ROW_INTS = 48   # a tree's first, limit and offset rows, 16 ints each
#: ints of a lane's table: the three root tables, then the three trees'
#: rows (csrc/decode_step.cu's LANE_INTS)
LANE_INTS = sum(1 << b for b in LUT_BITS) + 3 * ROW_INTS


@functools.lru_cache(maxsize=None)
def _lut_cand(bits: int, dev: torch.device) -> torch.Tensor:
    """[2**bits, bits]: root index v's candidate at length l + 1."""
    v = torch.arange(1 << bits, device=dev)
    return _bitrev15(v)[:, None] >> (14 - torch.arange(bits, device=dev))


@functools.lru_cache(maxsize=None)
def _cmd_codes(dev: torch.device) -> torch.Tensor:
    """int64 [704]: a command symbol's implicit-distance flag << 15,
    insert code << 16 and copy code << 21."""
    t = _tables_np()
    codes = (np.asarray(t["implicit0"], np.int64) << 15) \
        | (np.asarray(t["cmd2ins"], np.int64) << 16) \
        | (np.asarray(t["cmd2cpy"], np.int64) << 21)
    return torch.from_numpy(codes).to(dev)


def build_tree_lut(tree: dict, bits: int, cmd: bool = False
                   ) -> torch.Tensor:
    """Root table of `tree` (build_tree_device's rows): int32 [N,
    2**bits], indexed by the next `bits` window bits (LSB first).  Where
    a code of length k <= bits matches (the first such length, as
    _tree_decode finds it; its candidate depends on the first k bits
    only), the entry is k | sym << 5; a one-symbol tree gives sym with
    0 bits everywhere; elsewhere it is LUT_LONG, and the decoder goes on
    with the compare rule from length bits + 1.  A command tree's entry
    also carries the symbol's insert code << 16, copy code << 21 and
    implicit-distance flag << 15 (sym then takes bits 5-14)."""
    first, limit = tree["first"].long(), tree["limit"].long()
    a = tree["syms"].shape[1]
    cand = _lut_cand(bits, first.device)                   # [V, bits]
    ok = (cand[None] < limit[:, None, :bits]) \
        & (cand[None] >= first[:, None, :bits])            # [N, V, bits]
    l_idx = torch.argmax(ok.to(torch.int32), dim=2)        # first True
    c = cand.gather(1, l_idx.T).T
    pos = tree["offset"].long().gather(1, l_idx) + c - first.gather(1, l_idx)
    sym = tree["syms"].long().gather(1, pos.clamp(0, a - 1))
    nbits = l_idx + 1
    long = ~ok.any(2)
    sgl = tree["single"].long()[:, None]
    sym = torch.where(sgl >= 0, sgl, sym)
    nbits = torch.where(sgl >= 0, 0, nbits)
    long = long & (sgl < 0)
    entry = nbits | (sym << 5)
    if cmd:
        entry = entry | _cmd_codes(sym.device)[sym.clamp(0, 703)]
    return torch.where(long, LUT_LONG, entry).to(torch.int32)


def lut_tree_decode_ref(lut: torch.Tensor, tree: dict, bits: int, w_lo,
                        cmd: bool = False):
    """Plain version of the kernel's table decode, one symbol per lane
    from the low bits of w_lo (int64 holding u32): the root entry, and
    for LUT_LONG the compare rule from length bits + 1 (none found is
    bad and reads the length-1 slot).  Returns (symbol, bits consumed,
    bad), and for a command table also (insert code, copy code,
    implicit flag).  Held against _tree_decode in the tests; no path
    runs it."""
    e = lut.long().gather(1, (w_lo & ((1 << bits) - 1))[:, None])[:, 0]
    long = (e & LUT_LONG) != 0
    r = _bitrev15(w_lo & 0x7FFF)
    cand = r[:, None] >> (14 - torch.arange(15, device=w_lo.device))
    first = tree["first"].long()
    ok = (cand < tree["limit"]) & (cand >= first)
    ok[:, :bits] = False
    found = ok.any(1)
    l_idx = torch.where(found, torch.argmax(ok.to(torch.int32), dim=1), 0)
    li = l_idx[:, None]
    c = cand.gather(1, li)[:, 0]
    pos = tree["offset"].long().gather(1, li)[:, 0] + c \
        - first.gather(1, li)[:, 0]
    pos = pos.clamp(0, tree["syms"].shape[1] - 1)
    l_sym = tree["syms"].long().gather(1, pos[:, None])[:, 0]
    sym = torch.where(long, l_sym, (e >> 5) & 1023 if cmd else e >> 5)
    nbits = torch.where(long, l_idx + 1, e & 15)
    bad = long & ~found
    if not cmd:
        return sym, nbits, bad
    e = torch.where(long, _cmd_codes(w_lo.device)[sym.clamp(0, 703)], e)
    return sym, nbits, bad, (e >> 16) & 31, (e >> 21) & 31, (e >> 15) & 1


def lane_tables(trees) -> torch.Tensor:
    """The kernel's per-lane table, int32 [N, LANE_INTS]: the literal,
    command and distance root tables, then each tree's first, limit and
    offset rows padded to 16.  A CTA copies its lanes' rows into shared
    memory as they are."""
    parts = [build_tree_lut(t, b, cmd=k == 1)
             for k, (t, b) in enumerate(zip(trees, LUT_BITS))]
    for t in trees:
        for key in ("first", "limit", "offset"):
            parts.append(torch.nn.functional.pad(t[key], (0, 1)))
    return torch.cat(parts, dim=1).contiguous()


#: warps a decode_step CTA holds at most
PLAN_MAX_WARPS = 8
#: dynamic shared bytes a CTA can have on an H100
SMEM_MAX = 232448
assert 4 * (HOT_INTS + PLAN_MAX_WARPS * LANE_INTS) <= SMEM_MAX


def decode_step_plan(n: int, sms: int) -> dict:
    """decode_step's grid on n lanes and a card of `sms` SMs, the one
    place it is decided: one lane a warp (the rest of the warp only
    stages), so that each lane's phase branches are its own (the faster
    placement on an H100, PERF.md); `lanes_per_cta` warps a CTA, at most
    PLAN_MAX_WARPS and at most the lanes an SM gets when every SM has a
    CTA (n // sms, at least 1), so that n >= sms gives every SM a CTA;
    `smem_bytes` of dynamic shared memory hold the hot constants and
    each lane's table."""
    if n < 1 or sms < 1:
        raise ValueError(f"decode_step_plan: no plan for {n} lanes, {sms} "
                         f"SMs")
    lanes = min(PLAN_MAX_WARPS, max(1, n // sms))
    return dict(lanes_per_cta=lanes, threads=32 * lanes,
                ctas=-(-n // lanes),
                smem_bytes=4 * (HOT_INTS + lanes * LANE_INTS))


# ---------------------------------------------------------------------------
# The step loop: plain version
# ---------------------------------------------------------------------------


def _shr_or(lo, hi, k):
    """(lo >> k) | (hi << (32 - k)) as u32 for 0 < k < 32; lo for k 0."""
    return torch.where(k > 0, (lo >> k) | ((hi << (32 - k)) & M32), lo)


def _shifted_pair(w_lo, w_hi, k):
    """(lo, hi) view of the 64-bit window starting k (< 64) bits in."""
    k32 = k >= 32
    lo = torch.where(k32, w_hi, w_lo)
    hi = torch.where(k32, 0, w_hi)
    kk = k & 31
    return _shr_or(lo, hi, kk), torch.where(kk > 0, hi >> kk, hi)


def _shifted64(w_lo, w_hi, k):
    """The 32 bits starting k (< 64) bits into the window."""
    k32 = k >= 32
    lo = torch.where(k32, w_hi, w_lo)
    hi = torch.where(k32, 0, w_hi)
    return _shr_or(lo, hi, k & 31)


def _mask(v, nb):
    return v & ((1 << nb) - 1)


def batch_decode_ref(data, bit0, mlen, window, npostfix, ndirect, cache0,
                     lit_len, cmd_len, dist_len, out_prefix, max_steps: int,
                     s_lit: int, s_cmd: int, steps_out=None):
    """Plain PyTorch version of the step loop (decode_tpu.py's
    `lax.while_loop` body, step for step).  Arguments and outputs as
    batch_decode_device.  On CUDA tensors each chunk of _CHECK_EVERY
    steps replays one CUDA graph of those ops (the hundreds of launches
    a step would otherwise set its pace)."""
    n, L = data.shape
    dev = data.device
    lit_tree = build_tree_device(lit_len)
    cmd_tree = build_tree_device(cmd_len)
    dist_tree = build_tree_device(dist_len)
    t = {k: torch.as_tensor(np.asarray(v, np.int64), device=dev)
         for k, v in _tables_np().items()}
    outlen = t["dict_outlen"].view(121, 25)
    a_dist = dist_tree["syms"].shape[1]
    lane = torch.arange(n, device=dev)
    ar8 = torch.arange(8, device=dev)
    mlen, window = mlen.long(), window.long()
    npostfix, ndirect = npostfix.long(), ndirect.long()
    out_prefix = out_prefix.long()

    def window64(bit_pos):
        idx = ((bit_pos >> 3)[:, None] + ar8[None, :]).clamp(0, L - 1)
        b = data.gather(1, idx).long()
        lo = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
        hi = b[:, 4] | (b[:, 5] << 8) | (b[:, 6] << 16) | (b[:, 7] << 24)
        sh = bit_pos & 7
        return _shr_or(lo, hi, sh), torch.where(sh > 0, hi >> sh, hi)

    def dist_decode(cache, wl, wh):
        d_sym, d_bits0, d_bad = _tree_decode(dist_tree, wl)
        dcode = d_sym.clamp(0, a_dist - 1)
        d15 = dcode.clamp(0, 15)
        short_d = cache.gather(1, t["sc_idx"][d15].clamp(0, 3)[:, None])[
            :, 0] + t["sc_delta"][d15]
        direct_d = dcode - 16 + 1
        h = (dcode - ndirect - 16).clamp(min=0)
        hcode = h >> npostfix
        lcode = h & ((1 << npostfix) - 1)
        nbits_raw = 1 + (hcode >> 1)
        nbits = nbits_raw.clamp(0, 24)  # > 24 is malformed
        offs = ((2 + (hcode & 1)) << nbits) - 4
        extra = _mask(_shr_or(wl, wh, d_bits0), nbits)
        long_d = ((offs + extra) << npostfix) + lcode + ndirect + 1
        is_short = dcode < 16
        is_direct = ~is_short & (dcode < 16 + ndirect)
        dd = torch.where(is_short, short_d,
                         torch.where(is_direct, direct_d, long_d))
        db = torch.where(is_short | is_direct, d_bits0, d_bits0 + nbits)
        d_bad = d_bad | (is_short & (dd <= 0)) \
            | (~is_short & ~is_direct & (nbits_raw > 24))
        return dd, db, d_bad, dcode

    zeros = torch.zeros(n, dtype=torch.int64, device=dev)
    st = dict(bit=bit0.long(), phase=zeros, out_len=zeros, ins_code=zeros,
              cpy_code=zeros, ins_rem=zeros, cur_ins=zeros, copy_len=zeros,
              impl=zeros, cache=cache0.long(), nlit=zeros, ncmd=zeros,
              steps=zeros)
    lits = torch.zeros((n, s_lit), dtype=torch.uint8, device=dev)
    cmds = torch.zeros((n, s_cmd, 3), dtype=torch.int32, device=dev)

    def body(st):
        phase = st["phase"]
        live = phase < PH_DONE
        w_lo, w_hi = window64(st["bit"])
        is_cmd = live & (phase == PH_CMD)
        is_ext = live & (phase == PH_EXTRAS)
        is_lit = live & (phase == PH_LIT)
        is_dst = live & (phase == PH_DIST)

        # command symbol; its extras fused when the 57-bit window covers
        # symbol + both extras
        c_sym, c_bits, c_bad = _tree_decode(cmd_tree, w_lo)
        c_sym = c_sym.clamp(0, 703)
        n_ins = t["cmd2ins"][c_sym]
        n_cpy = t["cmd2cpy"][c_sym]
        n_impl = t["implicit0"][c_sym]
        ic_eff = torch.where(is_cmd, n_ins, st["ins_code"])
        cc_eff = torch.where(is_cmd, n_cpy, st["cpy_code"])
        base_off = torch.where(is_cmd, c_bits, 0)
        iebits = t["ins_extra"][ic_eff]
        cebits = t["cpy_extra"][cc_eff]
        fits = (base_off + iebits + cebits) <= 57
        v_ins = _mask(_shifted64(w_lo, w_hi, base_off), iebits)
        v_cpy = _mask(_shifted64(w_lo, w_hi, base_off + iebits), cebits)
        e_ins_len = t["ins_base"][ic_eff] + v_ins
        e_cpy_len = t["cpy_base"][cc_eff] + v_cpy
        e_bits = iebits + cebits

        # up to 3 literals from one window
        l_sym, l_bits, l_bad = _tree_decode(lit_tree, w_lo)
        l_sym2, l_bits2, l_bad2 = _tree_decode(
            lit_tree, _shifted64(w_lo, w_hi, l_bits))
        l_sym3, l_bits3, l_bad3 = _tree_decode(
            lit_tree, _shifted64(w_lo, w_hi, l_bits + l_bits2))

        cache = st["cache"]
        distance, d_bits, d_bad, dcode = dist_decode(cache, w_lo, w_hi)

        ext_eff = (is_cmd & fits) | is_ext
        take2 = is_lit & (st["ins_rem"] >= 2)
        take3 = is_lit & (st["ins_rem"] >= 3)
        nl = is_lit.long() + take2.long() + take3.long()
        lit_bits = l_bits + torch.where(take2, l_bits2, 0) \
            + torch.where(take3, l_bits3, 0)
        consumed = torch.where(
            is_cmd, c_bits + torch.where(fits, e_bits, 0),
            torch.where(is_ext, e_bits,
                        torch.where(is_lit, lit_bits,
                                    torch.where(is_dst, d_bits, 0))))
        bit = st["bit"] + consumed
        bad = (is_cmd & c_bad) | (is_lit & l_bad) | (take2 & l_bad2) \
            | (take3 & l_bad3) | (is_dst & d_bad)

        out_len = st["out_len"]
        mrem = mlen - out_len
        ins_code = torch.where(is_cmd, n_ins, st["ins_code"])
        cpy_code = torch.where(is_cmd, n_cpy, st["cpy_code"])
        impl = torch.where(is_cmd, n_impl, st["impl"])
        e_over = ext_eff & (e_ins_len > mrem)
        ins_rem = torch.where(ext_eff, e_ins_len, st["ins_rem"])
        cur_ins = torch.where(ext_eff, e_ins_len, st["cur_ins"])
        copy_len = torch.where(ext_eff, e_cpy_len, st["copy_len"])

        # emit up to 3 literal bytes (clipped writes, in order)
        for k, (take, sym) in enumerate(((is_lit, l_sym), (take2, l_sym2),
                                         (take3, l_sym3))):
            li = (st["nlit"] + k).clamp(0, s_lit - 1)
            lits[lane, li] = torch.where(take, sym.to(torch.uint8),
                                         lits[lane, li])
        nlit = st["nlit"] + nl
        out_len = out_len + nl
        ins_rem = ins_rem - nl

        lit_done = (is_lit & (ins_rem == 0)) | (ext_eff & ~e_over
                                                & (e_ins_len == 0))
        block_end = lit_done & (out_len == mlen)
        use_impl = lit_done & ~block_end & (impl == 1)
        impl_dist = cache[:, 0]
        # the distance fused into this step, decoded at the lane's
        # offset when the window still covers it
        f_off = torch.where(is_cmd, c_bits + e_bits,
                            torch.where(is_ext, e_bits, lit_bits))
        fl, fh = _shifted_pair(w_lo, w_hi, f_off)
        f_dist, f_bits, f_bad, f_dcode = dist_decode(cache, fl, fh)
        want_f = lit_done & ~block_end & (impl == 0)
        is_fdst = want_f & ~f_bad & (f_off <= 42) & (f_off + f_bits <= 57)
        max_dist = torch.minimum(out_len + out_prefix, window)

        # copy emit (implicit, fused or DIST step); a distance past
        # max_dist is a static-dictionary word of the transform's length
        is_copy = use_impl | is_dst | is_fdst
        eff_dist = torch.where(is_dst, distance,
                               torch.where(is_fdst, f_dist, impl_dist))
        is_dictref = is_copy & (eff_dist > max_dist)
        word_id = eff_dist - max_dist - 1
        cl_ok = (copy_len >= 4) & (copy_len <= 24)
        cl_idx = copy_len.clamp(0, 24)
        sb = t["dict_sbits"][cl_idx]
        transform = torch.where(sb < 31, word_id >> sb.clamp(max=30), 121)
        dict_ok = is_dictref & cl_ok & (transform < 121) & (word_id >= 0)
        dict_add = outlen[transform.clamp(0, 120), cl_idx]
        dict_bad = is_dictref & ~dict_ok
        adv = torch.where(is_dictref, dict_add, copy_len)
        c_over = is_copy & ~dict_bad & (adv > mlen - out_len)

        emit_cmd = block_end | (is_copy & ~dict_bad & ~c_over)
        row = torch.stack([cur_ins, torch.where(block_end, 0, copy_len),
                           torch.where(block_end, 0, eff_dist)], dim=1)
        ci = st["ncmd"].clamp(0, s_cmd - 1)
        cmds[lane, ci] = torch.where(emit_cmd[:, None], row.to(torch.int32),
                                     cmds[lane, ci])
        ncmd = st["ncmd"] + emit_cmd.long()
        out_len = out_len + torch.where(emit_cmd & ~block_end, adv, 0)

        # ring cache: push on explicit non-dictionary non-zero codes
        push = ((is_dst & (dcode != 0)) | (is_fdst & (f_dcode != 0))) \
            & ~is_dictref & ~c_over
        new_cache = torch.stack([eff_dist, cache[:, 0], cache[:, 1],
                                 cache[:, 2]], dim=1)
        cache = torch.where(push[:, None], new_cache, cache)
        bit = bit + torch.where(is_fdst, f_bits, 0)

        bad = bad | e_over | dict_bad | c_over | (nlit > s_lit) \
            | (ncmd > s_cmd)
        done_now = emit_cmd & (out_len == mlen)
        nphase = torch.where(
            is_cmd & ~fits, PH_EXTRAS,
            torch.where(ext_eff & ~lit_done, PH_LIT,
                        torch.where(lit_done & ~block_end & (impl == 0),
                                    PH_DIST, phase)))
        nphase = torch.where(is_copy & ~dict_bad & ~c_over & ~done_now,
                             PH_CMD, nphase)
        nphase = torch.where(done_now | block_end, PH_DONE, nphase)
        nphase = torch.where(bad, PH_FALLBACK, nphase)
        nphase = torch.where(live, nphase, phase)
        return dict(bit=torch.where(live, bit, st["bit"]), phase=nphase,
                    out_len=out_len, ins_code=ins_code, cpy_code=cpy_code,
                    ins_rem=ins_rem, cur_ins=cur_ins, copy_len=copy_len,
                    impl=impl, cache=cache, nlit=nlit, ncmd=ncmd,
                    steps=st["steps"] + live.long())

    def chunk(st, k):
        for _ in range(k):
            st = body(st)
        return st

    # on CUDA, whole chunks replay one captured graph of the same ops
    replay = None
    if dev.type == "cuda" and max_steps >= _CHECK_EVERY:
        st, replay = _graph_chunk(lambda s: chunk(s, _CHECK_EVERY), body, st,
                                  dev)
    steps = 0
    while steps < max_steps:
        k = min(_CHECK_EVERY, max_steps - steps)
        if replay is not None and k == _CHECK_EVERY:
            replay()
        else:
            st = chunk(st, k)
        steps += k
        if not bool((st["phase"] < PH_DONE).any()):
            break
    if steps_out is not None:
        steps_out.copy_(st["steps"])
    i32 = torch.int32
    return (lits, st["nlit"].to(i32), cmds, st["ncmd"].to(i32),
            st["bit"].to(i32), st["phase"].to(i32), st["cache"].to(i32))


def _graph_chunk(fn, body, st, dev):
    """A CUDA graph of `fn` (state -> state) over a copy of `st` that
    writes its result back into the copy.  Returns (the copy, replay):
    each replay advances the copy in place, with the same ops as an
    eager call and none of their launch cost.  The warm-up step before
    the capture writes the literal and command slots the first step
    writes, with the same values, so the replays' result is unchanged."""
    static = {k: v.clone() for k, v in st.items()}
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body(dict(static))
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(static)
            for k, v in out.items():
                static[k].copy_(v)
    return static, graph.replay


# ---------------------------------------------------------------------------
# The step loop: wrapper and kernel launch
# ---------------------------------------------------------------------------


def batch_decode_device(data, bit0, mlen, window, npostfix, ndirect, cache0,
                        lit_len, cmd_len, dist_len, out_prefix,
                        max_steps: int, s_lit: int, s_cmd: int,
                        steps_out=None):
    """One-symbol-per-step batched decode of N lanes.

    data [N, L] uint8 (each lane's stream, zero-padded), bit0 / mlen /
    window / npostfix / ndirect / out_prefix [N] int32, cache0 [N, 4]
    int32, lit_len [N, 256] / cmd_len [N, 704] / dist_len [N, A] code
    lengths (any integer type).  Every lane runs at most `max_steps`
    steps.  Returns (lits [N, s_lit] uint8, nlit [N], cmds [N, s_cmd, 3]
    int32 (insert length, copy length, distance; the trailing command
    may have copy length 0), ncmd [N], end_bit [N], status [N] (the
    final phase: PH_DONE is clean, anything else falls back), cache
    [N, 4]), int32 unless stated.  steps_out, an int32 [N] tensor,
    receives each lane's step count.  CUDA tensors launch the kernel;
    CPU tensors run batch_decode_ref."""
    n, L = data.shape
    dev = data.device
    vecs = (bit0, mlen, window, npostfix, ndirect, out_prefix)
    if data.dtype != torch.uint8 or data.dim() != 2 \
            or any(v.shape != (n,) or v.device != dev for v in vecs) \
            or cache0.shape != (n, 4) or cache0.device != dev \
            or lit_len.shape != (n, 256) or cmd_len.shape != (n, 704) \
            or dist_len.dim() != 2 or dist_len.shape[0] != n \
            or any(x.device != dev for x in (lit_len, cmd_len, dist_len)):
        raise ValueError("batch_decode_device: inconsistent lane arrays")
    if n == 0 or L == 0 or s_lit < 1 or s_cmd < 1:
        raise ValueError("batch_decode_device: empty batch or buffers")
    if steps_out is not None and (steps_out.shape != (n,)
                                  or steps_out.dtype != torch.int32
                                  or steps_out.device != dev):
        raise ValueError("batch_decode_device: steps_out must be int32 [N] "
                         "on the lanes' device")
    args = (data, bit0, mlen, window, npostfix, ndirect, cache0, lit_len,
            cmd_len, dist_len, out_prefix, int(max_steps), int(s_lit),
            int(s_cmd), steps_out)
    if dev.type == "cpu":
        return batch_decode_ref(*args)
    if dev.type != "cuda":
        raise ValueError(f"batch_decode_device: unsupported device {dev}")
    return _decode_step_cuda(*args)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _padded_rows(data: torch.Tensor) -> torch.Tensor:
    """data [N, L] as [N, Lp], Lp the multiple of 16 at or above L + 7,
    each row's bytes past L - 1 set to its byte L - 1.  The kernel reads
    a row as aligned 8-byte words with the word index clamped to the
    row's last word, which then holds only copies of byte L - 1: so
    every byte past L - 1, in the padding or beyond the row, reads as
    byte L - 1, as the byte window of the plain version clamps it."""
    n, L = data.shape
    lp = -(-(L + 7) // 16) * 16
    out = torch.empty((n, lp), dtype=torch.uint8, device=data.device)
    out[:, :L] = data
    out[:, L:] = data[:, L - 1:L]
    return out


def _decode_step_cuda(data, bit0, mlen, window, npostfix, ndirect, cache0,
                      lit_len, cmd_len, dist_len, out_prefix, max_steps,
                      s_lit, s_cmd, steps_out):
    """The kernel launch, on decode_step_plan's grid (kept in
    LAST_PLAN)."""
    n = data.shape[0]
    dev = data.device
    lib = LIB.get()
    i32 = torch.int32
    trees = [build_tree_device(x) for x in (lit_len, cmd_len, dist_len)]
    ins = [x.to(i32).contiguous() for x in
           (bit0, mlen, window, npostfix, ndirect, out_prefix, cache0)]
    rows = _padded_rows(data)
    plan = decode_step_plan(n, _sm_count(dev.index or 0))
    lits = torch.zeros((n, s_lit), dtype=torch.uint8, device=dev)
    cmds = torch.zeros((n, s_cmd, 3), dtype=i32, device=dev)
    outs = [torch.empty(n, dtype=i32, device=dev) for _ in range(4)]
    cache = torch.empty((n, 4), dtype=i32, device=dev)
    steps = steps_out if steps_out is not None else \
        torch.empty(n, dtype=i32, device=dev)
    # pointers and sizes in the order of csrc/decode_step.cu's Params
    ptrs = [rows] + ins + [_kernel_table(dev), lane_tables(trees)]
    ptrs += [tr["syms"] for tr in trees]
    ptrs += [lits, cmds, *outs, cache, steps]
    sizes = [n, rows.shape[1], trees[2]["syms"].shape[1], max_steps, s_lit,
             s_cmd, plan["lanes_per_cta"], plan["ctas"], plan["smem_bytes"]]
    p_arr = (ctypes.c_int64 * len(ptrs))(*[x.data_ptr() for x in ptrs])
    s_arr = (ctypes.c_int64 * len(sizes))(*sizes)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.decode_step_launch(p_arr, s_arr, len(ptrs), len(sizes),
                                     stream)
    if err != 0:
        raise RuntimeError(f"decode_step_launch failed: CUDA error {err}")
    LAUNCHES["decode_step"] = LAUNCHES.get("decode_step", 0) + 1
    LAST_PLAN.clear()
    LAST_PLAN.update(plan, lanes=n)
    nlit, ncmd, end_bit, status = outs
    return lits, nlit, cmds, ncmd, end_bit, status, cache


# ---------------------------------------------------------------------------
# TPU probe #9's kernel function
# ---------------------------------------------------------------------------


def step_probe_ref(tab: torch.Tensor, st: torch.Tensor, steps: int,
                   reads: int) -> torch.Tensor:
    """Plain version of research/decode_step_kernel_probe.py's kernel:
    per lane, `steps` times: st = (st * 1103515245 + 12345) & 0x3FF
    (int32 wrapping), acc = sum over r < reads of tab[lane, st + r],
    st = (st + acc) & 0x3FF.  tab int32 [lanes, >= 1024 + reads], st
    int32 [1, lanes]; returns int32 [1, lanes]."""
    s = st[0].long()
    tab = tab.long()
    lane = torch.arange(tab.shape[0], device=tab.device)
    for _ in range(steps):
        s = (s * 1103515245 + 12345) & 0x3FF
        acc = torch.zeros_like(s)
        for r in range(reads):
            acc = acc + tab[lane, s + r]
        s = (s + acc) & 0x3FF
    return s.to(torch.int32)[None, :]


#: most lanes (one a warp) in a step_probe CTA
PROBE_MAX_LANES = 8
#: step_probe: each lane's row starts on a boundary of this many bytes in
#: shared memory (csrc/decode_step.cu PROBE_ROW_ALIGN)
PROBE_ROW_ALIGN = 4096
#: the read counts of the probe (P3, P1, P2)
PROBE_READS = (0, 1, 2)


def step_probe_plan(lanes: int, width: int, sms: int) -> dict:
    """step_probe's grid on `lanes` table rows of `width` int32 and a
    card of `sms` SMs, the one place it is decided: one lane a warp (its
    thread 0 runs the chain, the warp stages), `lanes_per_cta` warps a
    CTA, at most PROBE_MAX_LANES, at most the lanes an SM gets when every
    SM has a CTA (lanes // sms, at least 1) and at most the rows that fit
    in a CTA's shared memory; `smem_bytes` hold the CTA's rows, each
    rounded up to PROBE_ROW_ALIGN bytes, and PROBE_ROW_ALIGN bytes of
    slack to align the first.  Raises where one row does not fit."""
    if lanes < 1 or width < 1 or sms < 1:
        raise ValueError(f"step_probe_plan: no plan for {lanes} lanes of "
                         f"{width} words on {sms} SMs")
    stride = -(-4 * width // PROBE_ROW_ALIGN) * PROBE_ROW_ALIGN
    fit = (SMEM_MAX - PROBE_ROW_ALIGN) // stride
    if fit < 1:
        raise ValueError(f"step_probe_plan: a row of {width} int32 does not "
                         f"fit in {SMEM_MAX} shared bytes")
    per = min(PROBE_MAX_LANES, max(1, lanes // sms), fit)
    return dict(lanes_per_cta=per, threads=32 * per, ctas=-(-lanes // per),
                smem_bytes=PROBE_ROW_ALIGN + per * stride)


def step_probe(tab: torch.Tensor, st: torch.Tensor, steps: int,
               reads: int) -> torch.Tensor:
    """The probe's step loop: on CUDA tensors the kernel on
    step_probe_plan's grid (kept in LAST_PROBE_PLAN), each lane's row in
    shared memory; step_probe_ref on CPU tensors.  reads is 0, 1 or 2."""
    lanes = tab.shape[0] if tab.dim() == 2 else -1
    if tab.dtype != torch.int32 or st.dtype != torch.int32 \
            or tab.dim() != 2 or st.shape != (1, lanes) \
            or tab.device != st.device or reads not in PROBE_READS \
            or tab.shape[1] < 1024 + reads or steps < 0:
        raise ValueError("step_probe: tab must be int32 [lanes, >= 1024 + "
                         "reads] and st int32 [1, lanes] on one device, "
                         "reads 0, 1 or 2")
    dev = tab.device
    if dev.type == "cpu":
        return step_probe_ref(tab, st, steps, reads)
    if dev.type != "cuda":
        raise ValueError(f"step_probe: unsupported device {dev}")
    width = tab.shape[1]
    plan = step_probe_plan(lanes, width, _sm_count(dev.index or 0))
    lib = LIB.get()
    tab, st = tab.contiguous(), st.contiguous()
    out = torch.empty_like(st)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.step_probe_launch(tab.data_ptr(), st.data_ptr(),
                                    out.data_ptr(), lanes, width, steps,
                                    reads, plan["lanes_per_cta"],
                                    plan["ctas"], plan["smem_bytes"], stream)
    if err != 0:
        raise RuntimeError(f"step_probe_launch failed: CUDA error {err}")
    for key in ("step_probe", f"step_probe_reads{reads}"):
        LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    LAST_PROBE_PLAN.clear()
    LAST_PROBE_PLAN.update(plan, lanes=lanes, width=width, reads=reads)
    return out


# the instruction kinds latency_probe times, in csrc/decode_step.cu's
# order; "IADD3" is timed in pairs with a LOP3 (a chain of adds alone
# may be merged three operands at a time)
_LAT_KINDS = ("IMAD", "LOP3", "IADD3+LOP3", "LDS")
_LAT_UNROLL = 64                  # csrc/decode_step.cu LAT_UNROLL
_LAT_ITERS = (16, 80)             # loop trips of the short and long chain


def latency_probe(dev: torch.device) -> dict:
    """Dependent latency in cycles of IMAD, LOP3, IADD3 and LDS on the
    card: one thread times loops of 16 and 80 trips of 64 dependent
    instructions of each kind with clock64 (csrc/decode_step.cu
    latency_probe_kernel); a kind's latency is the difference over the
    4,096 instructions between them."""
    lib = LIB.get()
    vals = torch.from_numpy(np.array(
        [7, 0x2545F491, 12345, 0x9E3779B9, 0x85EBCA6B], np.uint32)
        .view(np.int32)).to(dev)
    cycles = torch.zeros(2 * len(_LAT_KINDS), dtype=torch.int64, device=dev)
    sink = torch.zeros(len(_LAT_KINDS), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.latency_probe_launch(vals.data_ptr(), *_LAT_ITERS,
                                       cycles.data_ptr(), sink.data_ptr(),
                                       stream)
    if err != 0:
        raise RuntimeError(f"latency_probe_launch failed: CUDA error {err}")
    c = cycles.cpu().tolist()
    n = (_LAT_ITERS[1] - _LAT_ITERS[0]) * _LAT_UNROLL
    lat = {k: (c[2 * i + 1] - c[2 * i]) / n
           for i, k in enumerate(_LAT_KINDS)}
    lat["IADD3"] = lat.pop("IADD3+LOP3") - lat["LOP3"]
    return lat


def step_latency_path(reads: int) -> list:
    """The dependent instructions of one step of csrc/decode_step.cu's
    step_probe_kernel as sm_90a builds it (its SASS, read with cuobjdump): for
    reads > 0 the LCG's IMAD, the LOP3 that masks it into the row's
    address, the LDS (two issue together), for two reads the IADD3 of
    the two, and the IMAD that adds four times the reads to the address;
    with no read the compiler folds four LCG steps into one IMAD, a
    quarter of one a step."""
    if reads == 0:
        return [("IMAD", 0.25)]
    return [("IMAD", 1), ("LOP3", 1), ("LDS", 1)] \
        + [("IADD3", 1)] * (reads - 1) + [("IMAD", 1)]


def step_latency_cycles(reads: int, lat: dict) -> float:
    """Cycles of one probe step's critical path (step_latency_path) at
    the latencies `lat` (latency_probe)."""
    return sum(lat[k] * n for k, n in step_latency_path(reads))


def sm_clock_khz(index: int) -> int:
    """The SM clock of CUDA device `index` in kHz, as
    cudaDeviceProp.clockRate gives it (cudaDevAttrClockRate)."""
    khz = LIB.get().sm_clock_khz(index)
    if khz <= 0:
        raise RuntimeError("sm_clock_khz: cudaDevAttrClockRate failed")
    return khz
