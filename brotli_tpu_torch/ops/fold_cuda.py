"""Fold over content-sorted match candidates: CUDA kernel + wrappers.

Counterpart of brotli_tpu/ops/fold_pallas.py.  `fold_sorted` launches
the CUDA C++ kernel in csrc/fold.cu on CUDA tensors (built with nvcc
for sm_90a at first use, loaded with ctypes) and runs the plain
PyTorch version `fold_sorted_ref` on CPU tensors; on a CUDA tensor it
launches the kernel or raises.  LAUNCHES counts kernel launches per
configuration; the grid comes from `fold_plan` alone, and LAST_PLAN
holds the plan of the last launch.  `fold_sorted_exits` is the scan
with the kernel's early exits in torch: it gives fold_sorted_ref's
outputs and counts the (row, offset) pairs the exits leave.

The tier wrappers keep fold_pallas' names and results: a stable
content sort (torch.sort(stable=True) on one packed key, then gathers
of the payloads), one fold, and either the sorted-space outputs
(invert=False; the host applies the permutation) or position space.
Key order is part of the semantics: the q2-q6 fold and the q9 short
fold sort by signed int32(v0), the exact8 fold by unsigned (v0, v1).
Either way rows of equal v0 are contiguous, and the one-key sort is
stable with pos the original index, which the kernel's exits need.
"""

from __future__ import annotations

import ctypes

import torch

from ..buildcache import CudaLibrary
from .matching import (DISTANCE_BIT_PENALTY, MIN_SCORE_DELTA, as_i32,
                       ctz_bytes, floor_log2, u32_values, u32_values_at)

MAX_PAY = 5  # payload operands the kernel takes (csrc/fold.cu kMaxPay)
MAX_OFFSETS = 64    # k_fwd + k_back at most (kMaxOffsets)
THREADS = 256       # a CTA (kThreads)
TILE_ROWS = 512     # sorted rows a CTA folds (kTileRows)

#: kernel launches per configuration name (config_name(...)); reset
#: and read by callers that check a run went through the kernel
LAUNCHES: dict[str, int] = {}
#: the plan (fold_plan) of the last kernel launch
LAST_PLAN: dict = {}


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fold_sorted_launch.argtypes = ([vp] * 4 + [ci] + [vp] * 2
                                       + [ci] * 13 + [vp])
    lib.fold_sorted_launch.restype = ci


LIB = CudaLibrary("fold", _bind)


def config_name(n_keys: int, n_pay: int, k_fwd: int, k_back: int,
                fuse_short: bool = False) -> str:
    return (f"fold_k{n_keys}p{n_pay}_f{k_fwd}b{k_back}"
            + ("_short" if fuse_short else ""))


# ---------------------------------------------------------------------------
# The fold: launch plan, kernel launch and plain versions
# ---------------------------------------------------------------------------


def fold_plan(n: int, n_keys: int, n_pay: int, k_fwd: int, k_back: int,
              fuse_short: bool = False) -> dict:
    """The kernel's grid on n sorted rows, the one place it is decided:
    CTAs of THREADS threads, each folding TILE_ROWS rows staged as
    records with a k_fwd / k_back halo: one plane of 16 bytes a row, and
    past 4 words a second plane TILE_ROWS + MAX_OFFSETS rows further
    on.  Route "compact" (one key, at most one payload, as
    csrc/fold.cu's compact_route: after 8 offsets the rows still open
    are compacted into a list of 3 words a row and spread over the CTA's
    lanes) adds the list to the shared bytes; route "rows" keeps one
    lane a row.  Raises where the kernel takes no such fold."""
    if not (1 <= n_keys <= 2 and 0 <= n_pay <= MAX_PAY and 1 <= n < 1 << 31
            and k_fwd >= 0 and k_back >= 0
            and k_fwd + k_back <= MAX_OFFSETS
            and (not fuse_short or n_keys == 2)):
        raise ValueError(f"fold_plan: no kernel for {n} rows, {n_keys} "
                         f"keys, {n_pay} payloads, offsets {k_fwd}/"
                         f"{k_back}, fuse_short={fuse_short}")
    compact = n_keys == 1 and n_pay <= 1
    n_rec = TILE_ROWS + k_fwd + k_back
    smem = 16 * (n_rec if n_keys + 1 + n_pay <= 4
                 else TILE_ROWS + MAX_OFFSETS + n_rec)
    if compact:
        smem += 4 * 3 * TILE_ROWS
    return dict(route="compact" if compact else "rows",
                tile_rows=TILE_ROWS, threads=THREADS,
                ctas=-(-n // TILE_ROWS), smem_bytes=smem)


def fold_sorted(ops_sorted, min_pos: int, n_keys: int, k_fwd: int,
                k_back: int, window: int, lbs: int, len_shift: int,
                n_real: int, fuse_short: bool = False):
    """Fold over sorted int32 operands [keys..., pos, payloads...] (key
    and payload words as int32 bit patterns).  Returns (packed, score)
    int32 in SORTED space.  CUDA tensors launch the kernel on
    fold_plan's grid, CPU tensors run fold_sorted_ref.

    Precondition (the tier wrappers' sorts give it): the rows are
    sorted with v0 as the primary key (signed or unsigned), so rows of
    equal v0 are contiguous; with one key the sort is stable and pos is
    the original index, so pos ascends within a run of equal v0.  The
    kernel's early exits rest on it."""
    ops = list(ops_sorted)
    n = ops[0].shape[0]
    n_pay = len(ops) - n_keys - 1
    dev = ops[0].device
    for x in ops:
        if x.dtype != torch.int32 or x.dim() != 1 or x.shape[0] != n \
                or x.device != dev:
            raise ValueError("fold_sorted: operands must be 1-D int32 "
                             "tensors of one length on one device")
    if dev.type == "cpu":
        return fold_sorted_ref(ops, min_pos, n_keys, k_fwd, k_back,
                               window, lbs, len_shift, n_real, fuse_short)
    if dev.type != "cuda":
        raise ValueError(f"fold_sorted: unsupported device {dev}")
    plan = fold_plan(n, n_keys, n_pay, k_fwd, k_back, fuse_short)
    if not (0 <= window < 1 << 31 and 0 <= lbs <= 1 << 20
            and 0 <= len_shift <= 31 and abs(n_real) < 1 << 31
            and abs(min_pos) < 1 << 31):
        raise ValueError(f"fold_sorted: no kernel for window {window}, "
                         f"lbs {lbs}, len_shift {len_shift}, n_real "
                         f"{n_real}, min_pos {min_pos}")
    lib = LIB.get()
    ops = [x.contiguous() for x in ops]
    packed = torch.empty(n, dtype=torch.int32, device=dev)
    score = torch.empty(n, dtype=torch.int32, device=dev)
    key1 = ops[1].data_ptr() if n_keys == 2 else None
    pays = (ctypes.c_void_p * MAX_PAY)(
        *[x.data_ptr() for x in ops[n_keys + 1:]])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fold_sorted_launch(
            ops[0].data_ptr(), key1, ops[n_keys].data_ptr(), pays, n_pay,
            packed.data_ptr(), score.data_ptr(), n, int(n_real), n_keys,
            int(fuse_short), k_fwd, k_back, int(window), int(lbs),
            int(len_shift), int(min_pos), plan["tile_rows"], plan["ctas"],
            plan["smem_bytes"], stream)
    if err != 0:
        raise RuntimeError(f"fold_sorted_launch failed: CUDA error {err}")
    name = config_name(n_keys, n_pay, k_fwd, k_back, fuse_short)
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    LAST_PLAN.clear()
    LAST_PLAN.update(plan)
    return packed, score


def fold_sorted_ref(ops_sorted, min_pos: int, n_keys: int, k_fwd: int,
                    k_back: int, window: int, lbs: int, len_shift: int,
                    n_real: int, fuse_short: bool = False):
    """Plain PyTorch version of the fold: the neighbour at offset j is
    torch.roll(x, j), masked to rows whose i - j lies in [0, n)."""
    ops = list(ops_sorted)
    n = ops[0].shape[0]
    dev = ops[0].device
    keys = ops[:n_keys]
    pos = ops[n_keys]
    pays = ops[n_keys + 1:]
    limit = n_real - pos
    idx = torch.arange(n, device=dev)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    best_score, best_packed = zero, zero
    short_score, short_packed = zero, zero
    offs = list(range(1, k_fwd + 1)) + [-j for j in range(1, k_back + 1)]
    for j in offs:
        in_range = (idx - j >= 0) & (idx - j < n)
        same = keys[0] == torch.roll(keys[0], j)
        if n_keys == 2:
            x1 = keys[1] ^ torch.roll(keys[1], j)
            total = torch.where(same, 4 + ctz_bytes(x1), 0)
            alive = same & (x1 == 0)
        else:
            total = torch.where(same, 4, 0).to(torch.int32)
            alive = same
        cand = torch.roll(pos, j)
        dist = pos - cand
        for p in pays:
            m = ctz_bytes(p ^ torch.roll(p, j))
            total = total + torch.where(alive, m, 0)
            alive = alive & (m == 4)
        ml = torch.minimum(total, limit)
        base_ok = same & in_range & (dist > 0) & (dist <= window) \
            & (cand >= min_pos)
        logd = floor_log2(torch.clamp(dist, min=1))
        valid = base_ok & (ml >= 4)
        ml = torch.where(valid, ml, 0)
        sc = torch.where(ml > 0, lbs * ml - DISTANCE_BIT_PENALTY * logd, 0)
        upd = sc > best_score
        best_score = torch.where(upd, sc, best_score)
        best_packed = torch.where(upd, (ml << len_shift) | dist,
                                  best_packed)
        if fuse_short and j > 0:
            mls = torch.minimum(torch.clamp(total, max=8), limit)
            valid_s = base_ok & (mls >= 4)
            mls = torch.where(valid_s, mls, 0)
            scs = torch.where(mls > 0,
                              lbs * mls - DISTANCE_BIT_PENALTY * logd, 0)
            upds = scs > short_score
            short_score = torch.where(upds, scs, short_score)
            short_packed = torch.where(upds, (mls << len_shift) | dist,
                                       short_packed)
    if fuse_short:
        swin = short_score > best_score
        best_score = torch.where(swin, short_score, best_score)
        best_packed = torch.where(swin, short_packed, best_packed)
    gate = best_score > MIN_SCORE_DELTA
    return (torch.where(gate, best_packed, 0).to(torch.int32),
            torch.where(gate, best_score, 0).to(torch.int32))


def fold_sorted_exits(ops_sorted, min_pos: int, n_keys: int, k_fwd: int,
                      k_back: int, window: int, lbs: int, len_shift: int,
                      n_real: int, fuse_short: bool = False):
    """The fold as the kernel scans it, in torch: each row's scan stops
    in each direction at csrc/fold.cu's exact exits -- the first
    neighbour outside [0, n) or of another v0; with one key also the
    first forward neighbour with dist outside [1, min(window, pos -
    min_pos)] or with lbs * min(4 * (1 + n_pay), limit) - 30 *
    floor(log2 dist) <= best, and no backward scan; no scan at all
    where limit < 4.  Needs fold_sorted's precondition.  Returns
    (packed, score, pairs): the first two equal fold_sorted_ref's, and
    pairs[i] (int32) counts the candidates row i evaluates before its
    stops."""
    if fuse_short and n_keys != 2:
        raise ValueError("fold_sorted_exits: fuse_short needs two keys")
    ops = list(ops_sorted)
    n = ops[0].shape[0]
    dev = ops[0].device
    key0, pos, pays = ops[0], ops[n_keys], ops[n_keys + 1:]
    limit = n_real - pos
    top = lbs * torch.clamp(limit, max=4 * (n_keys + len(pays)))
    dbase = torch.clamp(torch.clamp(pos - min_pos, max=window), min=0)
    idx = torch.arange(n, device=dev)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    best, packed, sbest, spacked, pairs = zero, zero, zero, zero, zero
    offs = [range(1, k_fwd + 1)]
    if n_keys == 2:
        offs.append(range(-1, -k_back - 1, -1))
    for direction in offs:
        open_ = limit >= 4
        for j in direction:
            c = idx - j
            cc = c.clamp(0, n - 1)
            dist = pos - pos[cc]
            pen = DISTANCE_BIT_PENALTY * floor_log2(torch.clamp(dist, min=1))
            in_range = (dist >= 1) & (dist <= dbase)
            open_ = open_ & (c >= 0) & (c < n) & (key0[cc] == key0)
            if n_keys == 1:
                open_ = open_ & in_range & (top - pen > best)
            pairs = pairs + open_.to(torch.int32)
            ok = open_ & in_range
            if n_keys == 2:
                x1 = ops[1] ^ ops[1][cc]
                total = 4 + ctz_bytes(x1)
                alive = x1 == 0
            else:
                total = torch.full_like(pos, 4)
                alive = torch.ones_like(open_)
            for p in pays:
                m = ctz_bytes(p ^ p[cc])
                total = total + torch.where(alive, m, 0)
                alive = alive & (m == 4)
            ml = torch.minimum(total, limit)
            sc = lbs * ml - pen
            upd = ok & (sc > best)
            best = torch.where(upd, sc, best).to(torch.int32)
            packed = torch.where(upd, (ml << len_shift) | dist,
                                 packed).to(torch.int32)
            if fuse_short and j > 0:
                mls = torch.minimum(torch.clamp(total, max=8), limit)
                scs = lbs * mls - pen
                upds = ok & (scs > sbest)
                sbest = torch.where(upds, scs, sbest).to(torch.int32)
                spacked = torch.where(upds, (mls << len_shift) | dist,
                                      spacked).to(torch.int32)
    if fuse_short:
        swin = sbest > best
        best = torch.where(swin, sbest, best)
        packed = torch.where(swin, spacked, packed)
    gate = best > MIN_SCORE_DELTA
    return (torch.where(gate, packed, 0).to(torch.int32),
            torch.where(gate, best, 0).to(torch.int32), pairs)


# ---------------------------------------------------------------------------
# Tier wrappers (fold_pallas.py names and results)
# ---------------------------------------------------------------------------


def _invert(pos_s, packed_s, score_s=None):
    """Sorted space -> position space: out[pos_s[j]] = x[j] (pos_s is a
    permutation, so the scatter is deterministic)."""
    idx = pos_s.long()
    packed = torch.empty_like(packed_s).index_copy_(0, idx, packed_s)
    if score_s is None:
        return packed
    return packed, torch.empty_like(score_s).index_copy_(0, idx, score_s)


def _sort_v0(data, payload_values):
    """Stable sort by signed int32(v0); returns (v0_s, pos_s,
    *payloads_s) as int32."""
    return _sort_by_v0(as_i32(u32_values(data)), payload_values)


def _sort_by_v0(v0, payload_values):
    """Stable sort by the int32 key v0, payloads int64 holding u32;
    returns (v0_s, pos_s, *payloads_s) as int32."""
    key_s, order = torch.sort(v0, stable=True)
    return (key_s, order.to(torch.int32),
            *[as_i32(v)[order] for v in payload_values])


def _sort_v0v1(data, rounds: int):
    """Stable sort by unsigned (v0, v1) through one int64 key; returns
    (v0_s, v1_s, pos_s, *payloads_s) as int32, payloads v[2:rounds]."""
    return _sort_by_v0v1([u32_values_at(data, 4 * r)
                          for r in range(max(rounds, 2))])


def _sort_by_v0v1(v):
    """Stable sort by unsigned (v[0], v[1]) (int64 holding u32) through
    one int64 key, the first biased by -2^31 so signed order is unsigned
    order; returns (v0_s, v1_s, pos_s, *v[2:]_s) as int32."""
    key = ((v[0] - (1 << 31)) << 32) | v[1]
    _, order = torch.sort(key, stable=True)
    return (as_i32(v[0])[order], as_i32(v[1])[order],
            order.to(torch.int32),
            *[as_i32(x)[order] for x in v[2:]])


def best_matches_exact_p(data: torch.Tensor, window_size: int,
                         k: int = 32, rounds: int = 2,
                         literal_byte_score: int = 540, min_pos: int = 0,
                         len_shift: int = 26, invert: bool = True):
    """Greedy-tier (q2-q6) matcher: content sort by signed v0 + fold.
    invert=False returns (pos_s, packed_s) in sorted space."""
    n = data.shape[0]
    ops = _sort_v0(data, [u32_values_at(data, 4 * r)
                          for r in range(1, rounds)])
    packed_s, _ = fold_sorted(
        ops, min_pos, n_keys=1, k_fwd=k, k_back=0, window=window_size,
        lbs=literal_byte_score // 4, len_shift=len_shift, n_real=n)
    if not invert:
        return ops[1], packed_s
    return _invert(ops[1], packed_s)


def best_matches_exact8_p(data: torch.Tensor, window_size: int,
                          k: int = 16, rounds: int = 4,
                          literal_byte_score: int = 540, min_pos: int = 0,
                          len_shift: int = 26, invert: bool = True,
                          _with_score: bool = False):
    """q7/q8-tier matcher: one two-key (unsigned v0, v1) content sort +
    bidirectional fold.  invert=False returns (pos_s, packed_s,
    score_s)."""
    n = data.shape[0]
    ops = _sort_v0v1(data, rounds)
    packed_s, score_s = fold_sorted(
        ops, min_pos, n_keys=2, k_fwd=k, k_back=k // 2,
        window=window_size, lbs=literal_byte_score // 4,
        len_shift=len_shift, n_real=n)
    if not invert:
        return ops[2], packed_s, score_s
    if _with_score:
        return _invert(ops[2], packed_s, score_s)
    return _invert(ops[2], packed_s)


def _short_fold(data, window_size, k_short, literal_byte_score, min_pos,
                len_shift):
    """q9 short fold: sort by signed v0, one payload (v1), forward only;
    returns (pos_s, packed_s, score_s)."""
    n = data.shape[0]
    ops = _sort_v0(data, [u32_values_at(data, 4)])
    packed_s, score_s = fold_sorted(
        ops, min_pos, n_keys=1, k_fwd=k_short, k_back=0,
        window=window_size, lbs=literal_byte_score // 4,
        len_shift=len_shift, n_real=n)
    return ops[1], packed_s, score_s


def best_matches_exact9_p(data: torch.Tensor, window_size: int,
                          k: int = 16, k_short: int = 16,
                          rounds: int = 4,
                          literal_byte_score: int = 540, min_pos: int = 0,
                          len_shift: int = 26, invert: bool = True):
    """q9-tier matcher: the exact8 fold merged with an exact
    4-byte-recency short fold (key v0, one payload, lengths capped at
    8; the host extends len == 8 winners).  invert=False returns both
    folds' sorted-space (pos_s, packed_s, score_s), exact8's first."""
    out = (*best_matches_exact8_p(
        data, window_size, k=k, rounds=rounds,
        literal_byte_score=literal_byte_score, min_pos=min_pos,
        len_shift=len_shift, invert=False),
        *_short_fold(data, window_size, k_short, literal_byte_score,
                     min_pos, len_shift))
    return merge_exact9(out)[0] if invert else out


def merge_exact9(sorted_out):
    """best_matches_exact9_p's sorted-space outputs to position space,
    merged as the host's invert_merge32 merges them: the short fold's
    match where its score strictly beats the exact8 fold's.  Returns
    (packed, short_won), short_won the mask of those positions."""
    p8, s8 = _invert(*sorted_out[:3])
    ps, ss = _invert(*sorted_out[3:])
    short_won = ss > s8
    return torch.where(short_won, ps, p8), short_won


def best_matches_exact9_fused(data: torch.Tensor, window_size: int,
                              k: int = 16, rounds: int = 4,
                              literal_byte_score: int = 540,
                              min_pos: int = 0, len_shift: int = 26,
                              invert: bool = True):
    """q9-tier matcher, single-pass form: the cap-8 short fold runs
    inside the exact8 fold (fuse_short), its candidates taken from
    (v0, v1)-sorted adjacency.  invert=False returns (pos_s,
    packed_s)."""
    n = data.shape[0]
    ops = _sort_v0v1(data, rounds)
    packed_s, _ = fold_sorted(
        ops, min_pos, n_keys=2, k_fwd=k, k_back=k // 2,
        window=window_size, lbs=literal_byte_score // 4,
        len_shift=len_shift, n_real=n, fuse_short=True)
    if not invert:
        return ops[2], packed_s
    return _invert(ops[2], packed_s)
