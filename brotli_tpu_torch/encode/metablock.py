"""Metablock decisions made on the host: literal context modeling, the
host half of block splitting and the distance parameters.

A copy of brotli_tpu/encode/metablock.py.  Context modeling mirrors
the reference's static-map decision tree (ChooseContextMode UTF8
detection, DecideOverLiteralContextModeling,
ShouldUseComplexStaticContextMap) with the same entropy thresholds and
the same three static maps.  The block-split helpers (run hysteresis,
header-cost merge, run-length encoding) finish what the device Lloyd
loop in ops/split.py starts.  choose_distance_params is the optimal
parser's per-metablock NPOSTFIX/NDIRECT search.

The pure-Python metablock planner: split_symbols (chunked entropy
clustering with Lloyd iterations), cluster_context_histograms (the
q10+ dynamic context maps) and build_meta_block, whose MetaBlockPlan
bitstream.store_meta_block serializes.  It plans every metablock the
native store refuses (bitstream.store_meta_block_auto), as the JAX
package does.
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
from .bitstream import extract_literals
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


def choose_literal_context(data: np.ndarray, start: int, length: int,
                           quality: int, mode: int, size_hint: int):
    """The literal context of the metablock data[start:start + length]:
    (context mode, num_contexts, context_map[64]), the static map chosen
    where the mode is UTF8."""
    ctx_mode = choose_context_mode(data[start:start + length], quality, mode)
    if ctx_mode == C.CONTEXT_UTF8:
        return (ctx_mode, *choose_literal_context_map(data, start, length,
                                                      quality, size_hint))
    return ctx_mode, 1, np.zeros(64, dtype=np.int64)


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
# Block splitting: chunked entropy clustering
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


def _entropy_cost(hist: np.ndarray) -> float:
    """Approximate bits to code `hist` with its own prefix code."""
    return shannon_entropy(hist)


def _entropy_rows(M: np.ndarray) -> np.ndarray:
    """Shannon bits per row of a histogram matrix (vectorized).  Where a
    count is 0, M * log2(max(M, 1)) is 0.0 already, so the terms need
    no mask; they are formed in one buffer."""
    s = M.sum(axis=-1)
    t = np.maximum(M, 1.0)
    np.log2(t, out=t)
    t *= M
    t = t.sum(axis=-1)
    return np.where(s > 0, s * np.log2(np.maximum(s, 1)) - t, 0.0)


def _merge_types(assign: np.ndarray, hist: np.ndarray, k: int,
                 switch_cost: float, header_cost: float):
    """Greedy pairwise cluster merge while it reduces total cost
    (entropy + per-type header estimate): each round merges the pair
    i < j of least delta, the first in row-major order among equals,
    while that delta is negative.

    The merged entropies of the pairs are computed once; a merge of b
    into a then recomputes only a's pairs, and a's own entropy is the
    merged pair's.  Every other pair's histograms are unchanged, and
    each entropy is the same float64 reduction over the same 256
    values, so every delta, and every decision, is what recomputing
    all pairs each round gives.  The pair matrix holds +inf below its
    diagonal, so its row-major argmin is the upper triangle's."""
    ids = np.unique(assign)
    m = len(ids)
    if m <= 1:
        return assign
    # the types' histograms: sums of whole counts, which no order of
    # addition changes
    C_ = np.stack([hist[assign == t].sum(axis=0) for t in ids])
    e = _entropy_rows(C_)
    iu0, iu1 = np.triu_indices(m, 1)
    pair = np.full((m, m), np.inf)
    pair[iu0, iu1] = _entropy_rows(C_[iu0] + C_[iu1])
    owner = np.arange(k, dtype=assign.dtype)   # each type's type now
    while m > 1:
        delta = pair - e[:, None] - e[None, :] - header_cost
        j = int(np.argmin(delta))
        if delta.flat[j] >= 0.0:
            break
        a, b = divmod(j, m)                    # a < b: a keeps its index
        e[a] = pair[a, b]
        C_[a] += C_[b]
        owner[owner == ids[b]] = ids[a]
        keep = np.arange(m) != b
        C_, ids, e, pair = C_[keep], ids[keep], e[keep], pair[keep][:, keep]
        m -= 1
        row = _entropy_rows(C_[a] + C_)
        pair[:a, a] = row[:a]
        pair[a, a + 1:] = row[a + 1:]
    return owner[assign]


def split_symbols(syms: np.ndarray, alphabet_size: int, category: str,
                  iters: int = 3, max_types: int | None = None
                  ) -> BlockSplit:
    """Entropy-cluster a symbol stream into block types.

    Lloyd iterations: cost[chunk, type] = -hist_chunk · log2 p_type via
    one matmul; assignment hysteresis merges short runs (stand-in for the
    reference's switch-cost Viterbi, block_splitter.rs FindBlocks :223).

    max_types caps the cluster count below the category default (the
    literal store caps it at 256 // num_lit_ctx so block types x static
    contexts fit the 256-tree wire limit)."""
    p = SPLIT_PARAMS[category]
    if max_types is not None:
        p = dict(p, max_types=min(p["max_types"], max_types))
    n = len(syms)
    if n < MIN_LENGTH_FOR_SPLITTING:
        return BlockSplit.trivial(n)
    chunk = p["chunk"]
    nch = (n + chunk - 1) // chunk
    pad = nch * chunk - n
    padded = np.concatenate([syms, np.full(pad, -1, dtype=syms.dtype)])
    chunk_id = np.repeat(np.arange(nch), chunk)
    valid = padded >= 0
    flat = chunk_id[valid] * alphabet_size + padded[valid]
    hist = np.bincount(flat, minlength=nch * alphabet_size) \
        .reshape(nch, alphabet_size).astype(np.float64)

    k = int(min(p["max_types"], max(1, nch // 3), 256))
    if k <= 1:
        return BlockSplit.trivial(n)

    # init centroids from evenly spaced chunk groups
    seeds = np.linspace(0, nch, k + 1).astype(np.int64)
    cent = np.stack([hist[seeds[j]:max(seeds[j] + 1, seeds[j + 1])].sum(0)
                     for j in range(k)])

    assign = None
    for _ in range(iters):
        tot = cent.sum(axis=1, keepdims=True) + alphabet_size * 0.25
        logp = np.log2((cent + 0.25) / tot)            # [k, alphabet]
        cost = -(hist @ logp.T)                        # [nch, k]  (MXU shape)
        # amortized switch cost discourages fragmentation
        cost += p["switch_cost"] / max(1, chunk // 16)
        new_assign = cost.argmin(axis=1)
        new_assign = _hysteresis(new_assign, cost, p["min_run"])
        if assign is not None and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        cent = np.zeros((k, alphabet_size))
        np.add.at(cent, assign, hist)
        # retire empty clusters (they keep their centroid; harmless)

    # agglomerative merge: only keep types that pay for their header
    assign = _merge_types(assign, hist, k, p["switch_cost"],
                          p["header_cost"])

    return _chunk_split(assign, k, chunk, n)


def _chunk_split(assign: np.ndarray, k: int, chunk: int, n: int
                 ) -> BlockSplit:
    """The BlockSplit of n symbols whose chunk c has type assign[c]:
    the used types renumbered in order of first appearance (the first
    block is type 0), trivial where one is used.  Neighbouring runs of
    chunks differ in type, so each is one run of symbols, `chunk`
    symbols a chunk, the last run cut at n."""
    used, first_pos = np.unique(assign, return_index=True)
    order = used[np.argsort(first_pos)]
    remap = np.zeros(k, dtype=np.int64)
    remap[order] = np.arange(len(order))
    assign = remap[assign]
    num_types = len(order)
    if num_types == 1:
        return BlockSplit.trivial(n)
    types = np.repeat(assign, chunk)[:n]
    blocks = [(t, ln * chunk) for t, ln in _runs(assign)]
    t, ln = blocks[-1]
    blocks[-1] = (t, ln - (len(assign) * chunk - n))
    return BlockSplit(num_types, types, blocks)


def _hysteresis(assign: np.ndarray, cost: np.ndarray, min_run: int):
    """Absorb runs shorter than min_run into the cheaper neighbor: the
    one neighbor of a first or last run; else the previous one where
    its summed cost over the run is at most the next one's.  Up to 4
    passes, until one changes nothing.

    A pass decides every short run from the runs it starts with, so it
    is one step over arrays of runs.  A short run's costs are summed
    in position order from 0.0: with min_run 3 in every category that
    is one or two terms, a sum no order of addition changes."""
    out = assign.copy()
    n = len(out)
    for _ in range(4):
        starts = np.concatenate([[0], np.flatnonzero(np.diff(out)) + 1])
        lens = np.diff(np.append(starts, n))
        short = np.flatnonzero(lens < min_run)
        if len(starts) == 1 or len(short) == 0:   # also n == 0
            break
        last = len(starts) - 1
        types = out[starts]
        prev_t = types[np.maximum(short - 1, 0)]
        next_t = types[np.minimum(short + 1, last)]
        s0, ln = starts[short], lens[short]
        cp = np.zeros(len(short))
        cn = np.zeros(len(short))
        for off in range(int(ln.max())):
            inside = off < ln
            rows = np.where(inside, s0 + off, 0)
            cp = cp + np.where(inside, cost[rows, prev_t], 0.0)
            cn = cn + np.where(inside, cost[rows, next_t], 0.0)
        new_t = np.where(cp <= cn, prev_t, next_t)
        new_t[short == 0] = next_t[short == 0]
        new_t[short == last] = prev_t[short == last]
        types[short] = new_t
        out = np.repeat(types, lens)
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


# ---------------------------------------------------------------------------
# Context clustering
# ---------------------------------------------------------------------------


def cluster_context_histograms(bucket_hist: np.ndarray, max_trees: int,
                               header_cost: float):
    """Cluster per-(block type x context) histograms into trees
    (reference BrotliClusterHistograms, src/enc/cluster.rs:360): k-means
    reduction to max_trees followed by greedy pairwise merging while a
    merge saves more than the per-tree description cost.

    Returns (assign[buckets] -> tree id, tree_hists[ntrees, alphabet]).
    """
    nb, alpha = bucket_hist.shape
    totals = bucket_hist.sum(axis=1)
    used = np.nonzero(totals > 0)[0]
    if len(used) == 0:
        return np.zeros(nb, dtype=np.int64), np.zeros((1, alpha),
                                                      dtype=np.int64)
    hist = bucket_hist[used].astype(np.float64)

    k = int(min(max_trees, len(used)))
    # k-means initialization: largest buckets as seeds
    seeds = np.argsort(-totals[used])[:k]
    cent = hist[seeds].copy()
    assign = None
    for _ in range(6):
        tot = cent.sum(axis=1, keepdims=True) + alpha * 0.25
        logp = np.log2((cent + 0.25) / tot)
        cost = -(hist @ logp.T)
        new_assign = cost.argmin(axis=1)
        if assign is not None and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        cent = np.zeros((k, alpha))
        np.add.at(cent, assign, hist)

    # greedy pairwise merge with header-cost gating
    alive = sorted(set(assign.tolist()))
    cost_of = {t: shannon_entropy(cent[t]) for t in alive}
    merged = True
    while merged and len(alive) > 1:
        merged = False
        best_delta, best_pair = 0.0, None
        for ii in range(len(alive)):
            for jj in range(ii + 1, len(alive)):
                a, b = alive[ii], alive[jj]
                d = (shannon_entropy(cent[a] + cent[b])
                     - cost_of[a] - cost_of[b] - header_cost)
                if d < best_delta:
                    best_delta, best_pair = d, (a, b)
        if best_pair:
            a, b = best_pair
            cent[a] += cent[b]
            cost_of[a] = shannon_entropy(cent[a])
            alive.remove(b)
            assign = np.where(assign == b, a, assign)
            merged = True

    remap = {t: i for i, t in enumerate(sorted(set(assign.tolist())))}
    ntrees = len(remap)
    out_assign = np.zeros(nb, dtype=np.int64)
    out_assign[used] = np.array([remap[t] for t in assign])
    tree_hists = np.zeros((ntrees, alpha), dtype=np.int64)
    np.add.at(tree_hists, out_assign[used],
              bucket_hist[used])
    return out_assign, tree_hists


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


# ---------------------------------------------------------------------------
# Metablock plan: the full optimization pipeline
# ---------------------------------------------------------------------------


class MetaBlockPlan:
    """Everything bitstream.store_meta_block needs to serialize one
    optimized metablock."""
    __slots__ = (
        "mlen", "dist_params", "context_mode", "cmds", "literals",
        "lit_ntypes", "cmd_ntypes", "dist_ntypes",
        "lit_switch", "cmd_switch", "dist_switch",
        "ntrees_l", "cmap_l", "ntrees_d", "cmap_d",
        "lit_lengths", "cmd_lengths", "dist_lengths",
        "lit_tree", "cmd_tree", "dist_tree",
    )


def _safe(hist):
    if hist.sum() == 0:
        hist = hist.copy()
        hist[0] = 1
    return hist


def build_meta_block(full: np.ndarray, start: int, mlen: int,
                     cmds, dist_params, quality: int, size_hint: int,
                     mode: int = 0, enable_splits: bool = True,
                     num_lit_ctx=None, lit_static_map=None) -> MetaBlockPlan:
    """Optimize one metablock: block splits + context modeling +
    per-tree Huffman codes (reference BrotliBuildMetaBlockGreedy,
    metablock.rs:1022, with the static-context-map path of
    WriteMetaBlockInternal, encode.rs:2026-2111)."""
    def _lengths(h):
        return build_huffman_lengths(optimize_counts_for_rle(_safe(h)))

    plan = MetaBlockPlan()
    plan.mlen = mlen
    plan.dist_params = dist_params
    plan.cmds = cmds

    literals = extract_literals(full, start, cmds.insert_len,
                                cmds.copy_advance)
    plan.literals = literals
    n_lit = len(literals)

    context_mode = choose_context_mode(full[start:start + mlen],
                                       quality, mode)
    plan.context_mode = context_mode

    # ---- literal contexts (vectorized p1/p2 gather) ----
    lit_abs = _literal_positions(cmds, start)
    p1 = np.where(lit_abs >= 1, full[np.maximum(lit_abs - 1, 0)], 0)
    p2 = np.where(lit_abs >= 2, full[np.maximum(lit_abs - 2, 0)], 0)
    ctx = (C.CONTEXT_LUT0[context_mode][p1]
           | C.CONTEXT_LUT1[context_mode][p2]).astype(np.int64)

    # ---- static context map decision ----
    if num_lit_ctx is None:
        if context_mode == C.CONTEXT_UTF8:
            num_lit_ctx, lit_static_map = choose_literal_context_map(
                full, start, mlen, quality, size_hint)
        else:
            num_lit_ctx, lit_static_map = 1, np.zeros(64, dtype=np.int64)

    # ---- block splits ----
    dist_mask = (cmds.copy_len > 0) & ~C.CMD_IMPLICIT_DIST0[cmds.cmd_sym]
    dist_syms = cmds.dist_code[dist_mask]
    if enable_splits:
        lit_split = split_symbols(literals.astype(np.int64), 256, "literal",
                                  max_types=256 // max(1, int(num_lit_ctx)))
        cmd_split = split_symbols(cmds.cmd_sym, 704, "command")
        dist_split = split_symbols(dist_syms, dist_params.alphabet_size,
                                   "distance")
    else:
        lit_split = BlockSplit.trivial(n_lit)
        cmd_split = BlockSplit.trivial(len(cmds))
        dist_split = BlockSplit.trivial(len(dist_syms))

    # cap total literal trees at 256
    while lit_split.num_types * num_lit_ctx > 256:
        num_lit_ctx, lit_static_map = 1, np.zeros(64, dtype=np.int64)

    plan.lit_ntypes = lit_split.num_types
    plan.cmd_ntypes = cmd_split.num_types
    plan.dist_ntypes = dist_split.num_types
    plan.lit_switch = plan_block_switches(lit_split) \
        if lit_split.num_types >= 2 else None
    plan.cmd_switch = plan_block_switches(cmd_split) \
        if cmd_split.num_types >= 2 else None
    plan.dist_switch = plan_block_switches(dist_split) \
        if dist_split.num_types >= 2 else None

    alpha_d = dist_params.alphabet_size
    dynamic_ctx = quality >= 10 and n_lit > 512

    if dynamic_ctx:
        # ---- dynamic context maps: cluster per-(type, context)
        # histograms (the q10+/BrotliBuildMetaBlock path,
        # metablock.rs:133 + cluster.rs) ----
        buckets_l = lit_split.types * 64 + ctx
        bh = np.bincount(buckets_l * 256 + literals,
                         minlength=lit_split.num_types * 64 * 256
                         ).reshape(lit_split.num_types * 64, 256)
        cmap_l, lit_h = cluster_context_histograms(
            bh, max_trees=48, header_cost=300.0)
        plan.ntrees_l = lit_h.shape[0]
        plan.cmap_l = cmap_l
        lit_tree = cmap_l[buckets_l]

        dctx = C.distance_context_from_copy_len(
            cmds.copy_len[dist_mask])
        buckets_d = dist_split.types * 4 + dctx
        bhd = np.bincount(buckets_d * alpha_d + dist_syms,
                          minlength=dist_split.num_types * 4 * alpha_d
                          ).reshape(dist_split.num_types * 4, alpha_d)
        cmap_d, dist_h = cluster_context_histograms(
            bhd, max_trees=8, header_cost=500.0)
        plan.ntrees_d = dist_h.shape[0]
        plan.cmap_d = cmap_d
        plan.dist_tree = cmap_d[buckets_d]
    else:
        # ---- static context maps (q<10 greedy path) ----
        ntrees_l = lit_split.num_types * num_lit_ctx
        cmap_l = np.zeros(64 * lit_split.num_types, dtype=np.int64)
        for t in range(lit_split.num_types):
            cmap_l[t * 64:(t + 1) * 64] = \
                t * num_lit_ctx + lit_static_map
        plan.ntrees_l = ntrees_l
        plan.cmap_l = cmap_l
        lit_tree = lit_split.types * num_lit_ctx + lit_static_map[ctx] \
            if n_lit else np.zeros(0, dtype=np.int64)
        lit_h = np.bincount(lit_tree * 256 + literals,
                            minlength=ntrees_l * 256
                            ).reshape(ntrees_l, 256)

        ntrees_d = dist_split.num_types
        plan.ntrees_d = ntrees_d
        plan.cmap_d = np.repeat(np.arange(ntrees_d, dtype=np.int64), 4)
        plan.dist_tree = dist_split.types
        dist_h = np.bincount(dist_split.types * alpha_d + dist_syms,
                             minlength=ntrees_d * alpha_d
                             ).reshape(ntrees_d, alpha_d)

    plan.lit_tree = lit_tree
    plan.cmd_tree = cmd_split.types
    plan.lit_lengths = [_lengths(h) for h in lit_h]

    nct = cmd_split.num_types
    cmd_h = np.bincount(cmd_split.types * 704 + cmds.cmd_sym,
                        minlength=nct * 704).reshape(nct, 704)
    plan.cmd_lengths = [_lengths(h) for h in cmd_h]
    plan.dist_lengths = [_lengths(h) for h in dist_h]
    return plan


def _literal_positions(cmds, start: int) -> np.ndarray:
    """Absolute position in the input of each literal (vectorized)."""
    n = len(cmds)
    step = cmds.insert_len + cmds.copy_advance
    cmd_start = np.zeros(n, dtype=np.int64)
    np.cumsum(step[:-1], out=cmd_start[1:])
    cmd_start += start
    total = int(cmds.insert_len.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    owner = np.repeat(np.arange(n), cmds.insert_len)
    run_off = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(cmds.insert_len)[:-1]]),
        cmds.insert_len)
    return cmd_start[owner] + run_off


def plan_block_switches(split: BlockSplit):
    """Turn a BlockSplit into wire data: first block length + per-switch
    (type_symbol, len_code, len_extra_val, len_extra_bits) and the
    histograms for the type/length prefix codes (RFC 6)."""
    blocks = split.blocks
    first_len = blocks[0][1]
    ntypes = split.num_types
    type_syms = []
    len_codes = [int(C.get_block_length_code(first_len))]
    len_extra = []
    cur, prev = 0, 1
    for t, ln in blocks[1:]:
        if t == prev:
            s = 0
        elif t == (cur + 1) % ntypes:
            s = 1
        else:
            s = t + 2
        type_syms.append(s)
        lc = int(C.get_block_length_code(ln))
        len_codes.append(lc)
        len_extra.append((int(ln - C.BLOCK_LEN_BASE[lc]),
                          int(C.BLOCK_LEN_EXTRA[lc])))
        prev, cur = cur, t
    type_hist = np.bincount(np.array(type_syms, dtype=np.int64),
                            minlength=ntypes + 2) if type_syms else \
        np.zeros(ntypes + 2, dtype=np.int64)
    len_hist = np.bincount(np.array(len_codes, dtype=np.int64), minlength=26)
    # switch positions in symbol units: cumulative block lengths
    switch_at = np.cumsum([ln for _, ln in blocks[:-1]])
    return dict(first_len=first_len, type_syms=type_syms,
                len_codes=len_codes[1:], len_extra=len_extra,
                first_len_code=len_codes[0] if len_codes else 0,
                type_hist=type_hist, len_hist=len_hist,
                switch_at=switch_at)
