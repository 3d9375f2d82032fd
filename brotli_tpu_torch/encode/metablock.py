"""Metablock decisions made on the host: literal context modeling, the
host half of block splitting and the distance parameters.

A copy of the path's part of brotli_tpu/encode/metablock.py.  Context
modeling mirrors the reference's static-map decision tree
(ChooseContextMode UTF8 detection, DecideOverLiteralContextModeling,
ShouldUseComplexStaticContextMap) with the same entropy thresholds and
the same three static maps.  The block-split helpers (run hysteresis,
header-cost merge, run-length encoding) finish what the device Lloyd
loop in ops/split.py starts.  choose_distance_params is the optimal
parser's per-metablock NPOSTFIX/NDIRECT search.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core import constants as C
from ..core.bitio import BitWriter
from ..core.huffman import (build_huffman_lengths, code_bit_cost,
                            optimize_counts_for_rle)
from ..core.prefix import write_prefix_code
from .params import DistanceParams

# Static literal context maps (reference encode.rs:1724-1800).
STATIC_CONTEXT_MAP_CONTINUATION = np.zeros(64, dtype=np.int64)
STATIC_CONTEXT_MAP_CONTINUATION[[0, 1]] = 1
STATIC_CONTEXT_MAP_CONTINUATION[[2, 3]] = 2

STATIC_CONTEXT_MAP_SIMPLE_UTF8 = np.zeros(64, dtype=np.int64)
STATIC_CONTEXT_MAP_SIMPLE_UTF8[[2, 3]] = 1

STATIC_CONTEXT_MAP_COMPLEX_UTF8 = np.array([
    11, 11, 12, 12, 0, 0, 0, 0, 1, 1, 9, 9, 2, 2, 2, 2,
    1, 1, 1, 1, 8, 3, 3, 3, 1, 1, 1, 1, 2, 2, 2, 2,
    8, 4, 4, 4, 8, 7, 4, 4, 8, 0, 0, 0, 3, 3, 3, 3,
    5, 5, 10, 5, 5, 5, 10, 5, 6, 6, 6, 6, 6, 6, 6, 6,
], dtype=np.int64)


def shannon_entropy(counts: np.ndarray) -> float:
    c = np.asarray(counts, dtype=np.float64)
    total = c.sum()
    if total == 0:
        return 0.0
    nz = c[c > 0]
    return float(total * np.log2(total) - np.sum(nz * np.log2(nz)))


def is_mostly_utf8(data: np.ndarray, min_fraction: float = 0.75) -> bool:
    """Fraction of bytes covered by valid UTF-8 sequences (reference
    BrotliIsMostlyUTF8).  Inputs over 64KB are sampled with contiguous
    4KB blocks every 64KB."""
    n = len(data)
    if n == 0:
        return True
    d = data
    if n > (1 << 16):
        pos = np.arange(0, n - 4095, 1 << 16, dtype=np.int64)
        d = d[pos[:, None] + np.arange(4096)[None, :]].ravel()
        n = len(d)
    # classify each byte as an ASCII char or a valid continuation of a
    # 2/3-byte lead
    ascii_mask = d < 0x80
    lead2 = (d >= 0xC2) & (d < 0xE0)
    lead3 = (d >= 0xE0) & (d < 0xF0)
    cont = (d >= 0x80) & (d < 0xC0)
    ok2 = np.zeros(n, dtype=bool)
    ok2[:-1] = lead2[:-1] & cont[1:]
    ok3 = np.zeros(n, dtype=bool)
    ok3[:-2] = lead3[:-2] & cont[1:-1] & cont[2:]
    size_utf8 = int(ascii_mask.sum()) + 2 * int(ok2.sum()) + 3 * int(ok3.sum())
    return size_utf8 > min_fraction * n


def choose_context_mode(data: np.ndarray, quality: int, mode: int) -> int:
    """UTF8 when the input is mostly valid UTF-8, SIGNED otherwise;
    FONT mode forces SIGNED."""
    if mode == 2:  # MODE_FONT
        return C.CONTEXT_SIGNED
    if quality >= 4 and is_mostly_utf8(data):
        return C.CONTEXT_UTF8
    return C.CONTEXT_SIGNED


def _sampled_strides(data: np.ndarray, start: int, length: int):
    """64-byte strides every 4 KiB, gathered as one [nsamp, 64] matrix."""
    end = start + length
    pos = np.arange(start, end - 63, 4096, dtype=np.int64)
    if len(pos) == 0:
        return np.zeros((0, 64), dtype=data.dtype)
    return data[pos[:, None] + np.arange(64)[None, :]]


def choose_literal_context_map(data: np.ndarray, start: int, length: int,
                               quality: int, size_hint: int):
    """Static literal context map decision for UTF8 context mode.
    Returns (num_contexts, context_map[64])."""
    one = (1, np.zeros(64, dtype=np.int64))
    if quality < 5 or length < 64:
        return one

    if size_hint >= (1 << 20):
        got = _should_use_complex_map(data, start, length)
        if got is not None:
            return got

    # Bigram prefix histogram over 3 classes of the top-2 bits
    lut = np.array([0, 0, 1, 2], dtype=np.int64)
    S = _sampled_strides(data, start, length)
    cls = lut[S >> 6]
    idx = cls[:, :-1] * 3 + cls[:, 1:]
    bigram = np.bincount(idx.ravel(), minlength=9)

    mono = np.zeros(3, dtype=np.int64)
    two_prefix = np.zeros(6, dtype=np.int64)
    for i in range(9):
        mono[i % 3] += bigram[i]
        two_prefix[i % 6] += bigram[i]
    total = int(mono.sum())
    if total == 0:
        return one
    e1 = shannon_entropy(mono) / total
    e2 = (shannon_entropy(two_prefix[:3]) +
          shannon_entropy(two_prefix[3:])) / total
    e3 = sum(shannon_entropy(bigram[3 * i:3 * i + 3]) for i in range(3)) \
        / total
    if quality < 7:
        e3 = e1 * 10.0
    if e1 - e2 < 0.2 and e1 - e3 < 0.2:
        return one
    if e2 - e3 < 0.02:
        return 2, STATIC_CONTEXT_MAP_SIMPLE_UTF8
    return 3, STATIC_CONTEXT_MAP_CONTINUATION


def _should_use_complex_map(data: np.ndarray, start: int, length: int):
    """Reference ShouldUseComplexStaticContextMap."""
    lut0 = C.CONTEXT_LUT0[C.CONTEXT_UTF8]
    lut1 = C.CONTEXT_LUT1[C.CONTEXT_UTF8]
    S = _sampled_strides(data, start, length)
    p2 = S[:, :-2]
    p1 = S[:, 1:-1]
    lit = S[:, 2:]
    ctx = STATIC_CONTEXT_MAP_COMPLEX_UTF8[lut0[p1] | lut1[p2]]
    top5 = (lit >> 3).astype(np.int64)
    total = lit.size
    if total == 0:
        return None
    combined = np.bincount(top5.ravel(), minlength=32)
    context_histo = np.bincount((ctx * 32 + top5).ravel(),
                                minlength=13 * 32).reshape(13, 32)
    e1 = shannon_entropy(combined) / total
    e2 = sum(shannon_entropy(context_histo[i]) for i in range(13)) / total
    if e2 > 3.0 or e1 - e2 < 0.2:
        return None
    return 13, STATIC_CONTEXT_MAP_COMPLEX_UTF8


# ---------------------------------------------------------------------------
# Block splitting: chunked entropy clustering (host half)
# ---------------------------------------------------------------------------


class BlockSplit:
    """types[i] = block type of symbol i; blocks = [(type, length), ...]."""

    __slots__ = ("num_types", "types", "blocks")

    def __init__(self, num_types, types, blocks):
        self.num_types = num_types
        self.types = types
        self.blocks = blocks

    @classmethod
    def trivial(cls, n: int):
        return cls(1, np.zeros(n, dtype=np.int64), [(0, n)])


# Per-category tuning (reference block_splitter.rs:21-39: switch costs
# 28.1 / 13.5 / 14.6 bits, max types 100/50/50, min length 128).
SPLIT_PARAMS = {
    "literal": dict(chunk=256, max_types=32, switch_cost=28.1, min_run=3,
                    header_cost=320.0),
    "command": dict(chunk=128, max_types=16, switch_cost=13.5, min_run=3,
                    header_cost=500.0),
    "distance": dict(chunk=128, max_types=8, switch_cost=14.6, min_run=3,
                     header_cost=600.0),
}
MIN_LENGTH_FOR_SPLITTING = 128


def _entropy_rows(M: np.ndarray) -> np.ndarray:
    """Shannon bits per row of a histogram matrix (vectorized)."""
    s = M.sum(axis=-1)
    t = np.where(M > 0, M * np.log2(np.maximum(M, 1)), 0.0).sum(axis=-1)
    return np.where(s > 0, s * np.log2(np.maximum(s, 1)) - t, 0.0)


def _merge_types(assign: np.ndarray, hist: np.ndarray, k: int,
                 switch_cost: float, header_cost: float):
    """Greedy pairwise cluster merge while it reduces total cost
    (entropy + per-type header estimate); the all-pairs merged
    entropies are one [m, m, alpha] broadcast per round."""
    cent = np.zeros((k, hist.shape[1]))
    np.add.at(cent, assign, hist)
    ids = np.unique(assign)
    C_ = cent[ids]
    while len(ids) > 1:
        m = len(ids)
        e = _entropy_rows(C_)
        pair = _entropy_rows(C_[:, None, :] + C_[None, :, :])
        delta = pair - e[:, None] - e[None, :] - header_cost
        iu = np.triu_indices(m, 1)
        flat = delta[iu]
        j = int(np.argmin(flat))
        if flat[j] >= 0.0:
            break
        a, b = int(iu[0][j]), int(iu[1][j])
        C_[a] += C_[b]
        assign = np.where(assign == ids[b], ids[a], assign)
        C_ = np.delete(C_, b, axis=0)
        ids = np.delete(ids, b)
    return assign


def _hysteresis(assign: np.ndarray, cost: np.ndarray, min_run: int):
    """Absorb runs shorter than min_run into the cheaper neighbor."""
    out = assign.copy()
    changed = True
    passes = 0
    while changed and passes < 4:
        changed = False
        passes += 1
        runs = _runs(out)
        pos = 0
        for ri, (t, ln) in enumerate(runs):
            if ln < min_run and len(runs) > 1:
                prev_t = runs[ri - 1][0] if ri > 0 else None
                next_t = runs[ri + 1][0] if ri + 1 < len(runs) else None
                sl = slice(pos, pos + ln)
                if prev_t is None:
                    new_t = next_t
                elif next_t is None:
                    new_t = prev_t
                else:
                    cp = cost[sl, prev_t].sum()
                    cn = cost[sl, next_t].sum()
                    new_t = prev_t if cp <= cn else next_t
                if new_t != t:
                    out[sl] = new_t
                    changed = True
            pos += ln
    return out


def _runs(types: np.ndarray):
    """Run-length encode: [(type, length), ...]."""
    n = len(types)
    if n == 0:
        return []
    edges = np.nonzero(np.diff(types))[0] + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [n]])
    return [(int(types[s]), int(e - s)) for s, e in zip(starts, ends)]


_DIST_LANE_POOL = None
_DIST_LANE_LOCK = threading.Lock()


def _dist_lane_pool():
    """The four npostfix lanes' worker pool, made once (a pool a
    metablock paid a thread spawn and join on every one); made under a
    lock so that concurrent first callers share one."""
    global _DIST_LANE_POOL
    with _DIST_LANE_LOCK:
        if _DIST_LANE_POOL is None:
            _DIST_LANE_POOL = ThreadPoolExecutor(max_workers=4)
    return _DIST_LANE_POOL


def _dist_stream_cost(hist: np.ndarray, extra_cost: int) -> float:
    """The written cost of a distance symbol stream: its depth-limited
    Huffman code's bits plus the serialized tree plus the extra bits."""
    h = hist if hist.sum() else np.array([1], dtype=np.int64)
    lengths = build_huffman_lengths(optimize_counts_for_rle(h))
    w = BitWriter()
    write_prefix_code(w, lengths)
    return float(code_bit_cost(h, lengths)) + w.bit_length() + extra_cost


def choose_distance_params(distances: np.ndarray, copy_mask: np.ndarray,
                           dist_codes_now: np.ndarray,
                           large_window: bool = False) -> DistanceParams:
    """The (npostfix, ndirect) of least distance-stream cost (reference
    BrotliBuildMetaBlock, metablock.rs:158-208), the cost measured as
    the stream is written (_dist_stream_cost), with the full symbol
    histogram, short codes included.  Each npostfix lane sweeps its 16
    NDIRECT values and stops once the cost rises past its best; lanes
    of 2^15 distances or more run on the shared pool.  Ties go to the
    first lane."""
    long_mask = copy_mask & (dist_codes_now >= 16)
    dists = distances[long_mask]
    short_hist = np.bincount(dist_codes_now[copy_mask & ~long_mask],
                             minlength=16)[:16]
    if len(dists) == 0:
        return DistanceParams(large_window=large_window)

    def lane(npostfix):
        lbest = None
        prev = None
        for wire in range(16):  # NDIRECT = wire << npostfix (4 bits)
            ndirect = wire << npostfix
            direct = dists <= ndirect
            far = dists[~direct]
            if len(far):
                sym, _, nbits = C.encode_distance(far, npostfix, ndirect)
                hist = np.bincount(sym, minlength=16 + ndirect)
                extra_cost = int(nbits.sum())
            else:
                hist = np.zeros(16 + ndirect, dtype=np.int64)
                extra_cost = 0
            hist[:16] += short_hist
            if direct.any():
                hist[16:16 + ndirect] += np.bincount(
                    dists[direct] - 1, minlength=ndirect)
            total = _dist_stream_cost(hist, extra_cost)
            if lbest is None or total < lbest[0]:
                lbest = (total, npostfix, ndirect)
            # two strikes: the cost may dip once at a small ndirect
            if prev is not None and total > prev and total > lbest[0]:
                break
            prev = total
        return lbest

    if len(dists) >= (1 << 15):
        lane_bests = list(_dist_lane_pool().map(lane, range(4)))
    else:
        lane_bests = [lane(npf) for npf in range(4)]
    best = None
    for lb in lane_bests:
        if lb is not None and (best is None or lb[0] < best[0]):
            best = lb
    return DistanceParams(npostfix=best[1], ndirect=best[2],
                          large_window=large_window)
