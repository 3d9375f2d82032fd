"""The optimal parser of qualities 9.5 to 11: a Zopfli-style shortest
path over positions, priced by a fitted cost model.

The port's copy of brotli_tpu/encode/zopfli.py.  Reference:
BrotliCreateZopfliBackwardReferences / BrotliCreateHqZopfliBackward
References (src/enc/backward_references/hq.rs:984, :1237), a DP whose
edge costs come from a cost model (literal costs from a sliding-window
entropy, command and distance costs from histograms) refined over
iterations (hq.rs:1392-1443).

One region (a metablock, with up to a window of bytes before it as its
dictionary) is parsed in two steps:
  zopfli_collect   the candidates, which do not depend on the distance
                   cache: the deep all-match rings (q10 deep, q11) or
                   the scored top-K rows of three hashed searches (the
                   single-iteration tier), every transform-aware
                   dictionary match, and the literal cost estimate.
                   The encoder collects metablock g + 1 while it parses
                   and stores g.
  zopfli_segment   the DP iterations: iteration 0 priced by a greedy
                   pre-pass's histograms (one iteration) or by a gentle
                   prior (refining tiers), later iterations by the
                   previous parse's histograms, literal and distance
                   costs conditioned on their contexts; a converged
                   parse or cost stops early.
A single metablock of 256 KiB or more at one iteration, with no
dictionary, runs the collection and the DP overlapped
(_zopfli_segment_fast_overlapped).

The JAX package reads a few tuning knobs from the environment; here
they are the constants below at the reference's defaults.

Where the runtime is not in use (native_bridge.available() false), the
JAX package's no-runtime routes run: the collection takes three numpy
top-K searches (k = 64, k = 12, and a k8 = 24 long table with the
greedy tiers' dictionary probe; no deep rings and no all-transform
dictionary matches) and extends capped lengths in Python, the literal
costs come from a composite-key search (_sliding_key_counts), and each
iteration prices the edge list (_prepare_edges, _price_edges) for the
pure-Python DP (zopfli_parse) and its walk back (_backtrack).  The
overlapped tier is not entered.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native_bridge as nb
from ..core import constants as C
from .bitstream import extract_literals
from .command import resolve_commands
from .match import MATCH_CAP, extend_match, find_best_matches, greedy_parse
from .metablock import choose_context_mode

#: candidate rows a position of the early cost-model iterations visits
#: (the final iteration visits all of them)
_EARLY_CAND_CAP = 6
#: the final iteration's insert-start queue (the reference's
#: StartPosQueue holds 8, hq.rs:185)
_FINAL_STARTS = 5
#: candidate rows a position of the single-iteration tier visits
_FAST_CAND_CAP = 8
#: cost-model refinement rounds at q11 (with a convergence stop)
Q11_ITERS = 3
#: the overlapped tier's cost model is seeded from the greedy pre-pass
#: over this share of the rows
_OVERLAP_SEED_FRAC = 0.5

# insert / copy code lookup tables
_INS_CODE = np.searchsorted(C.INSERT_BASE, np.arange(1 << 16),
                            side="right") - 1
_COPY_CODE = np.searchsorted(C.COPY_BASE, np.arange(1 << 16),
                             side="right") - 1
_CMD_SYM = np.zeros((24, 24), dtype=np.int64)
for _i in range(24):
    _CMD_SYM[_i] = C.combine_length_codes(
        np.full(24, _i), np.arange(24), np.zeros(24, bool))
_CMD_SYM_LAST = np.zeros((24, 24), dtype=np.int64)
for _i in range(8):
    _CMD_SYM_LAST[_i, :16] = C.combine_length_codes(
        np.full(16, _i), np.arange(16), np.ones(16, bool))
# the pure-Python DP's lookups (list indexing beats numpy in its loop)
_INS_CODE_L = _INS_CODE.tolist()
_INS_EXTRA_L = C.INSERT_EXTRA.tolist()
_CMD_SYM_L = _CMD_SYM.tolist()


def _sliding_key_counts(keys: np.ndarray, queries: np.ndarray,
                        lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """count_i = #{j in [lo_i, hi_i] : keys[j] == queries[i]}, by one
    composite-key sort (key * n + pos ascends within a key)."""
    n = len(keys)
    order = np.argsort(keys, kind="stable")
    composite = keys[order].astype(np.int64) * n + order
    base = queries.astype(np.int64) * n
    h = np.searchsorted(composite, base + np.minimum(hi, n - 1),
                        side="right")
    lo_at = np.searchsorted(composite, base + np.maximum(lo, 0),
                            side="left")
    return h - lo_at


def estimate_literal_costs(data: np.ndarray):
    """Per-byte literal bit cost from a sliding local histogram
    (reference BrotliEstimateBitCostsForLiterals, literal_cost.rs:179):
    a +-495-byte window with UTF-8 context classes for mostly-UTF-8
    input, a +-2000-byte single histogram otherwise."""
    n = len(data)
    if n == 0:
        return np.zeros(0)
    utf8 = len(data.tobytes().decode("utf-8", errors="ignore").encode()) \
        > 0.75 * n
    if not utf8:
        if nb.available():
            return nb.est_lit(data, None, 2000, False, 0.029)
        d = data.astype(np.int64)
        return _window_costs(d, None, n, 2000, 0.029)
    # context class of position i from bytes i-1 (c) and i-2 (last):
    # ASCII or continuation 0, multibyte lead 1, interior 2
    # (literal_cost.rs:8), clamped by the sampled multi-byte level
    c = np.concatenate([[0], data[:-1]]).astype(np.int64)
    last = np.concatenate([[0, 0], data[:-2]]).astype(np.int64)
    cls2 = np.where(c < 128, 0,
                    np.where(c >= 192, 1, np.where(last < 0xE0, 0, 2)))
    counts = np.bincount(cls2, minlength=3)
    max_utf8 = 0 if counts[1] + counts[2] < 25 else (
        1 if counts[2] < 500 else 2)
    cls = np.minimum(cls2, max_utf8)
    if nb.available():
        return nb.est_lit(data, None if max_utf8 == 0
                          else cls.astype(np.uint8), 495, True, 0.02905)
    if max_utf8 == 0:
        d = data.astype(np.int64)
        cost = _window_costs(d, None, n, 495, 0.02905)
    else:
        key = cls * 256 + data
        cost = _window_costs(key, cls, n, 495, 0.02905)
    # the first 2000 positions ramp up (literal_cost.rs)
    idx = np.arange(n)
    return cost + (idx < 2000) * (
        0.7 - (2000 - np.minimum(idx, 2000)) / 2000.0 * 0.35)


def _window_costs(keys, cls, n, half, bias):
    """The bit cost of each position's key within its +-half window:
    log2(window) - log2(count) + bias, halved toward 1 below 1 bit.
    cls: count the window over the position's class alone (None: the
    whole window)."""
    idx = np.arange(n)
    lo, hi = idx - half + 1, idx + half
    cnt = _sliding_key_counts(keys, keys, lo, hi)
    if cls is None:
        w = np.minimum(hi, n - 1) - np.maximum(lo, 0) + 1
    else:
        w = _sliding_key_counts(cls, cls, lo, hi)
    cost = np.log2(np.maximum(w, 1)) - np.log2(np.maximum(cnt, 1)) + bias
    return np.where(cost < 1.0, cost * 0.5 + 0.5, cost)


def _set_cost(h, literal=False):
    """Histogram -> per-symbol bit cost (reference SetCost, hq.rs:1046):
    a missing symbol costs log2(sum [+ missing]) + 2, a present one at
    least 1 bit."""
    h = np.asarray(h, np.float64)
    s = h.sum()
    if s == 0:
        return np.full(len(h), 2.0)
    miss = s if literal else s + (h == 0).sum()
    return np.where(h > 0,
                    np.maximum(np.log2(s) - np.log2(np.maximum(h, 1)), 1.0),
                    np.log2(miss) + 2.0)


def _cost_tables(lit_hist, cmd_hist, dist_hist):
    return (_set_cost(lit_hist, literal=True), _set_cost(cmd_hist),
            _set_cost(dist_hist))


def _context_distance_costs(cmds, dist_alpha, beta: float = 32.0):
    """[4, alpha] distance symbol costs by the copy-length distance
    context, from the previous parse, smoothed toward the global
    distribution."""
    mask = (cmds.copy_len > 0) & ~C.CMD_IMPLICIT_DIST0[cmds.cmd_sym]
    ctx = C.distance_context_from_copy_len(cmds.copy_len[mask])
    h = np.zeros((4, dist_alpha), np.float64)
    np.add.at(h, (ctx, cmds.dist_code[mask]), 1.0)
    g = h.sum(axis=0)
    gp = g / max(g.sum(), 1.0)
    p = (h + beta * gp[None, :] + 1e-12) / (h.sum(axis=1)[:, None] + beta)
    return np.maximum(-np.log2(p), 1.0)


def _context_literal_costs(data_region, full, dict_len, cmds, mode: int = 2,
                           alpha: float = 64.0, bias: float = 0.4):
    """Per-position literal bit cost by the RFC literal context (lut0[p1]
    | lut1[p2]), from the previous parse's literals, smoothed toward
    the global distribution; the flat bias prices what the model leaves
    out (context-tree descriptions, context maps, block switches)."""
    n_cmd = len(cmds.insert_len)
    step = cmds.insert_len + cmds.copy_advance
    cmd_start = np.zeros(n_cmd, np.int64)
    np.cumsum(step[:-1], out=cmd_start[1:])
    total = int(cmds.insert_len.sum())
    lut0, lut1 = C.CONTEXT_LUT0[mode], C.CONTEXT_LUT1[mode]
    hist = np.zeros((64, 256), np.float64)
    if total:
        owner = np.repeat(np.arange(n_cmd), cmds.insert_len)
        run_off = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(cmds.insert_len)[:-1]]),
            cmds.insert_len)
        lpos = cmd_start[owner] + run_off
        absd = dict_len + lpos
        p1 = np.where(absd >= 1, full[np.maximum(absd - 1, 0)], 0)
        p2 = np.where(absd >= 2, full[np.maximum(absd - 2, 0)], 0)
        ctx = lut0[p1] | lut1[p2]
        np.add.at(hist, (ctx, data_region[lpos]), 1.0)
    ctx_tot = hist.sum(axis=1)
    g = hist.sum(axis=0)
    g = g / max(g.sum(), 1.0)
    p = (hist + alpha * g[None, :] + 1e-9) / (ctx_tot[:, None] + alpha)
    cost_tab = np.maximum(-np.log2(p), 1.0)
    idx = dict_len + np.arange(len(data_region))
    p1a = np.where(idx >= 1, full[np.maximum(idx - 1, 0)], 0)
    p2a = np.where(idx >= 2, full[np.maximum(idx - 2, 0)], 0)
    ctx_all = lut0[p1a] | lut1[p2a]
    return cost_tab[ctx_all, data_region] + bias


def _histograms_from_commands(data, cmds, dist_alpha):
    lits = extract_literals(data, 0, cmds.insert_len, cmds.copy_advance)
    lit_hist = np.bincount(lits, minlength=256)
    cmd_hist = np.bincount(cmds.cmd_sym, minlength=704)
    mask = (cmds.copy_len > 0) & ~C.CMD_IMPLICIT_DIST0[cmds.cmd_sym]
    dist_hist = np.bincount(cmds.dist_code[mask], minlength=dist_alpha)
    return lit_hist, cmd_hist, dist_hist


def _prepare_edges(cand_lens, cand_dists, cand_isdict, cand_wire,
                   dist_params, n, extra=None):
    """The edge list of the DP, grouped by source position: a match
    candidate's full length plus a ladder of shorter lengths (a
    dictionary match keeps its exact length).  Cost-independent: each
    iteration prices it with _price_edges."""
    npostfix, ndirect = dist_params.npostfix, dist_params.ndirect
    ci, pp = np.nonzero(cand_lens >= 2)
    L = cand_lens[ci, pp]
    D = cand_dists[ci, pp]
    ISD = cand_isdict[ci, pp]
    W = cand_wire[ci, pp]
    if extra is not None:
        srcs = extra if isinstance(extra, list) else [extra]
        pp = np.concatenate([pp] + [s[0] for s in srcs])
        L = np.concatenate([L] + [s[1] for s in srcs])
        D = np.concatenate([D] + [s[2] for s in srcs])
        ISD = np.concatenate([ISD] + [s[3] for s in srcs])
        W = np.concatenate([W] + [s[4] for s in srcs])
    # dedupe (p, d) pairs keeping the longest
    order = np.lexsort((-L, D, pp))
    pp, L, D, ISD, W = (pp[order], L[order], D[order], ISD[order],
                        W[order])
    keep = np.ones(len(pp), bool)
    keep[1:] = (pp[1:] != pp[:-1]) | (D[1:] != D[:-1])
    pp, L, D, ISD, W = pp[keep], L[keep], D[keep], ISD[keep], W[keep]
    # at most 12 window and 4 dictionary candidates a position, longest
    # first
    ordc = np.lexsort((-L, ISD, pp))
    pp, L, D, ISD, W = (pp[ordc], L[ordc], D[ordc], ISD[ordc], W[ordc])
    key = pp * 2 + ISD
    rank = np.arange(len(key)) - np.searchsorted(key, key, side="left")
    keepc = rank < np.where(ISD, 4, 12)
    pp, L, D, ISD, W, rank = (pp[keepc], L[keepc], D[keepc], ISD[keepc],
                              W[keepc], rank[keepc])
    # the sub-length ladder only for the 4 longest window candidates
    laddered = ~ISD & (rank < 4)
    sym_a = np.zeros(len(pp), np.int64)
    nbits_a = np.zeros(len(pp), np.int64)
    direct = D <= ndirect
    if direct.any():
        sym_a[direct] = 15 + D[direct]
    far = ~direct
    if far.any():
        sym, _, nbits = C.encode_distance(D[far], npostfix, ndirect)
        sym_a[far] = sym
        nbits_a[far] = nbits
    # ladder matrix: l - 1, l - 2, then fixed sub-lengths below l
    subs = np.array((4, 5, 6, 8, 10, 13, 16, 22, 32, 48, 64, 96, 128,
                     192), dtype=np.int32)
    ai = np.nonzero(laddered)[0]
    LA = L[ai].astype(np.int32)
    MA = np.zeros((len(ai), 2 + len(subs)), np.int32)
    MA[:, 0] = np.where(LA > 4, LA - 1, 0)
    MA[:, 1] = np.where(LA > 5, LA - 2, 0)
    MA[:, 2:] = np.where(LA[:, None] > subs[None, :], subs[None, :], 0)
    ciA, _ = np.nonzero(MA >= 2)
    lenA = MA[MA >= 2].astype(np.int64)
    ciA = ai[ciA]
    ci = np.concatenate([np.arange(len(pp)), ciA])
    e_len = np.concatenate([L, lenA])
    e_wire = np.concatenate([W, lenA])
    src = pp[ci]
    order = np.argsort(src, kind="stable")
    src = src[order]
    ci = ci[order]
    e_len = e_len[order]
    e_wire = e_wire[order]
    e_dist = D[ci]
    e_ccode = _COPY_CODE[np.minimum(e_wire, (1 << 16) - 1)]
    e_sym = sym_a[ci]
    e_nbits = nbits_a[ci]
    e_dctx = np.maximum(np.minimum(e_wire, 5) - 2, 0)
    edge_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=edge_off[1:])
    return (edge_off, e_len, e_wire, e_dist, e_ccode, e_sym, e_nbits,
            e_dctx)


def _price_edges(prepared, cost_dist):
    """One iteration's prices of prepared edges: the distance symbol's
    cost (by the copy-length context when cost_dist is [4, alpha]) plus
    the distance and copy extra bits."""
    (edge_off, e_len, e_wire, e_dist, e_ccode, e_sym, e_nbits,
     e_dctx) = prepared
    cost_dist = np.asarray(cost_dist)
    if cost_dist.ndim == 2:
        e_dcost = cost_dist[e_dctx, e_sym] + e_nbits
    else:
        e_dcost = cost_dist[e_sym] + e_nbits
    e_base = e_dcost + C.COPY_EXTRA[e_ccode]
    return edge_off, e_len, e_wire, e_dist, e_ccode, e_base, e_dcost


def zopfli_parse(n: int, lcp: np.ndarray, cost_cmd, edges):
    """The DP over a priced edge list (_price_edges plus the short-code
    costs, the data, the dictionary length, the window and the initial
    distance cache): cost[j] is the least bits of a parse of [0, j)
    that ends at a copy's end; insert runs close through the running
    minimum start.  Returns (ins, wire, dist, advance).  The runtime's
    DP (zopfli_dp_cache, which also probes the distance cache) where it
    is in use, else the pure-Python one, which takes the edges alone."""
    (edge_off, e_len, e_wire, e_dist, e_ccode, e_base, e_dcost,
     cost_dist_short, data, dict_len, window_size, initial_cache) = edges
    if nb.available():
        cost, prev_start, prev_len, prev_wire, prev_dist = \
            nb.zopfli_dp_cache(
                n, lcp, cost_cmd, cost_dist_short, edge_off, e_len, e_wire,
                e_dist, e_ccode, e_base, e_dcost, _INS_CODE,
                C.INSERT_EXTRA, _CMD_SYM.reshape(-1),
                _CMD_SYM_LAST.reshape(-1), data, dict_len, window_size,
                initial_cache)
        return _finish_parse(n, lcp, cost, prev_start, prev_len,
                             prev_wire, prev_dist)
    inf = float("inf")
    cost = [inf] * (n + 1)
    cost[0] = 0.0
    prev_start = [0] * (n + 1)
    prev_len = [0] * (n + 1)
    prev_wire = [0] * (n + 1)
    prev_dist = [0] * (n + 1)
    lcp_l = lcp.tolist()
    cost_cmd_l = cost_cmd.tolist()
    eo = edge_off.tolist()
    el, ew, ed, ec, eb = (e_len.tolist(), e_wire.tolist(), e_dist.tolist(),
                          e_ccode.tolist(), e_base.tolist())
    best_adj = inf
    best_u = 0
    for p in range(n):
        c = cost[p]
        if c < inf:
            adj = c - lcp_l[p]
            if adj < best_adj:
                best_adj = adj
                best_u = p
        e0, e1 = eo[p], eo[p + 1]
        if e0 == e1:
            continue
        lp = lcp_l[p]
        for e in range(e0, e1):
            ll = el[e]
            tgt = p + ll
            if tgt > n:
                continue
            ccode = ec[e]
            base = eb[e]
            ct = cost[tgt]
            # start 1: the running-minimum u (maybe a long insert)
            il = p - best_u
            ic = _INS_CODE_L[il] if il < 65536 else 23
            t = (best_adj + lp + base + _INS_EXTRA_L[ic]
                 + cost_cmd_l[_CMD_SYM_L[ic][ccode]])
            if t < ct:
                cost[tgt] = ct = t
                prev_start[tgt] = best_u
                prev_len[tgt] = ll
                prev_wire[tgt] = ew[e]
                prev_dist[tgt] = ed[e]
            # start 2: no insert, from p
            if cost[p] < inf and best_u != p:
                t = cost[p] + base + cost_cmd_l[_CMD_SYM_L[0][ccode]]
                if t < ct:
                    cost[tgt] = t
                    prev_start[tgt] = p
                    prev_len[tgt] = ll
                    prev_wire[tgt] = ew[e]
                    prev_dist[tgt] = ed[e]
    return _backtrack(n, lcp_l, cost, prev_start, prev_len, prev_wire,
                      prev_dist, best_adj, best_u)


def _finish_parse(n, lcp, cost, prev_start, prev_len, prev_wire,
                  prev_dist):
    """The cheapest close of the DP and the walk back (shared by the
    edge-list and candidate DPs): the runtime's, or numpy's scan for
    the close and _backtrack."""
    if nb.available():
        return nb.zopfli_backtrack(n, lcp, cost, prev_start, prev_len,
                                   prev_wire, prev_dist)
    cost = np.asarray(cost)
    lcp = np.asarray(lcp)
    adj = np.where(cost[:n] < 1e29, cost[:n] - lcp[:n], np.inf)
    best_u = int(np.argmin(adj)) if n else 0
    best_adj = float(adj[best_u]) if n else float("inf")
    return _backtrack(n, lcp, cost, prev_start, prev_len, prev_wire,
                      prev_dist, best_adj, best_u)


def _backtrack(n, lcp, cost, prev_start, prev_len, prev_wire, prev_dist,
               best_adj, best_u):
    """The walk back from n: a final literal run from best_u where that
    closes the stream cheaper (or no copy reaches n), then each copy
    back to its start.  Returns lists (ins, wire, dist, advance)."""
    ins, cps, dst, adv = [], [], [], []
    pos = n
    if cost[n] >= 1e29 or best_adj + float(lcp[n]) < cost[n]:
        ins.append(n - best_u)
        cps.append(0)
        dst.append(0)
        adv.append(0)
        pos = best_u
    while pos > 0:
        u = int(prev_start[pos])
        ln = int(prev_len[pos])
        ins.append(pos - ln - u)
        cps.append(int(prev_wire[pos]))
        dst.append(int(prev_dist[pos]))
        adv.append(ln)
        pos = u
    for a in (ins, cps, dst, adv):
        a.reverse()
    return ins, cps, dst, adv


def _collect_candidates(full, window_size, dict_len, literal_byte_score,
                        use_dictionary):
    """The candidate rows [3, n]: where the runtime is in use, a k=32
    deep hash-4 table's best and runner-up (another distance) and a
    shallow hash-8 table with the dictionary, the searches side by side
    (ctypes drops the GIL) and backing off over matchless runs; else
    the best of three numpy searches, one after another (k=64, k=12 and
    a k8=24 long table with the dictionary)."""
    if not nb.available():
        rows = []
        for kw in (dict(k=64, bucket_bits=15, k8=0, use_dictionary=False),
                   dict(k=12, bucket_bits=14, k8=0, use_dictionary=False),
                   dict(k=1, bucket_bits=17, k8=24,
                        use_dictionary=use_dictionary)):
            bl, bd, _, isd, bw = find_best_matches(
                full, window_size, dict_len=dict_len,
                literal_byte_score=literal_byte_score, **kw)
            rows.append((bl, bd, isd, bw))
        return tuple(np.stack([r[k] for r in rows]) for k in range(4))

    def deep():
        return nb.find_best_matches(
            full, window_size, dict_len=dict_len,
            literal_byte_score=literal_byte_score, k=32, bucket_bits=15,
            k8=0, use_dictionary=False, want_top2=True, miss_economy=True)

    def shallow():
        return find_best_matches(
            full, window_size, dict_len=dict_len,
            literal_byte_score=literal_byte_score, k=1, bucket_bits=17,
            k8=16, use_dictionary=use_dictionary, miss_economy=True)

    with ThreadPoolExecutor(max_workers=2) as ex:
        fut_deep, fut_shallow = ex.submit(deep), ex.submit(shallow)
        bl, bd, _, isd, bw, b2l, b2d = fut_deep.result()
        sl, sd, _, sisd, sw = fut_shallow.result()
    rows = [(bl, bd, isd, bw), (b2l, b2d, np.zeros(len(b2l), bool), b2l),
            (sl, sd, sisd, sw)]
    return tuple(np.stack([r[k] for r in rows]) for k in range(4))


def zopfli_collect(full: np.ndarray, params, dict_len: int = 0, iters=None):
    """The cache-independent candidates of one region (data[dict_len:]
    parsed, data[:dict_len] its dictionary): a dict of cand_lens,
    cand_dists, cand_isdict, cand_wire ([rows, n]: the single-iteration
    tier's rows, else none), extra (the sparse sources: the deep
    all-match rings of the refining tiers and the dictionary matches)
    and lit_costs.  The passes run one after another, but for the
    dictionary probe of the single-iteration tier, which overlaps its
    row searches: each streams a large working set."""
    n = len(full) - dict_len
    window_size = params.window_size
    if iters is None:
        iters = Q11_ITERS if params.quality >= 11 else 2
    use_prior = params.quality >= 10 and iters > 1
    cm = cd = fut_cd = None
    native = nb.available()
    # without the runtime: the numpy rows alone (no deep rings, no
    # all-transform dictionary matches), as the JAX package
    if use_prior and native:
        # the refining tiers take every window candidate from the deep
        # rings (k=96 ring + k8=48 long ring, increasing lengths)
        cm = nb.collect_matches(full, window_size, dict_len=dict_len, k=96,
                                k8=48, max_per_pos=16)
    if params.quality >= 10 and not params.catable and native:
        from .static_dict import collect_dict_matches, sorted_dict_index
        sorted_dict_index()
        if use_prior:
            cd = collect_dict_matches(full, dict_len, window_size)
        else:
            cd_ex = ThreadPoolExecutor(max_workers=1)
            fut_cd = cd_ex.submit(collect_dict_matches, full, dict_len,
                                  window_size)
            cd_ex.shutdown(wait=False)
    lit_costs = estimate_literal_costs(full[dict_len:])
    if cm is None:
        cand_lens, cand_dists, cand_isdict, cand_wire = _collect_candidates(
            full, window_size, dict_len, params.literal_byte_score,
            not params.catable)
        # exact lengths for cap-hit matches; inside a span an extended
        # match already covers, a capped one is kept (the long edge from
        # the span's start dominates), which keeps the work O(n)
        hits = np.argwhere((cand_lens >= MATCH_CAP) & ~cand_isdict)
        hits = hits[np.argsort(hits[:, 1], kind="stable")]
        if len(hits) and native:
            hc, hp = hits[:, 0], hits[:, 1]
            ext = nb.extend_caps(full, dict_len, hp, cand_dists[hc, hp],
                                 cand_lens[hc, hp])
            cand_lens[hc, hp] = ext
            cand_wire[hc, hp] = ext
        else:
            last_end = -1
            for ci, p in hits.tolist():
                if p < last_end - 32:
                    continue
                d = int(cand_dists[ci, p])
                ext = extend_match(full, dict_len + p - d, dict_len + p,
                                   int(cand_lens[ci, p]), n - p)
                cand_lens[ci, p] = ext
                cand_wire[ci, p] = ext
                last_end = max(last_end, p + ext)
    else:
        cand_lens = np.zeros((0, n), dtype=np.int64)
        cand_dists = np.zeros((0, n), dtype=np.int64)
        cand_isdict = np.zeros((0, n), dtype=bool)
        cand_wire = np.zeros((0, n), dtype=np.int64)
    if fut_cd is not None:
        cd = fut_cd.result()
    extra = None
    if params.quality >= 10:
        xs = []
        if cm is not None:
            mp, ml, md = cm
            xs.append((mp, ml, md, np.zeros(len(mp), bool), ml))
        if cd is not None:
            dp_, dl_, dd_, dw_ = cd
            xs.append((dp_, dl_, dd_, np.ones(len(dp_), bool), dw_))
        if xs:
            extra = xs
    return dict(cand_lens=cand_lens, cand_dists=cand_dists,
                cand_isdict=cand_isdict, cand_wire=cand_wire, extra=extra,
                lit_costs=lit_costs)


def _zopfli_segment_fast_overlapped(full: np.ndarray, params,
                                    initial_cache):
    """The single-iteration tier on one metablock with no dictionary,
    with the collection and the DP overlapped: the three candidate
    passes run on worker threads, each advancing a progress mark over
    the positions its rows cover, and this thread follows them with the
    chunked candidate preparation and the chunked DP (the runtime's
    range entry points carry their state across chunks).  The cost
    model is seeded from the greedy pre-pass over the first
    _OVERLAP_SEED_FRAC of the rows, so the DP starts before the
    collection ends (the serial path seeds it from all of them); the
    rows, extensions and DP are the serial path's.  Returns (ins, wire, dist, advance), or None where the
    dictionary matches overflow their rows (the caller then parses
    serially; the JAX package waits forever there, ROADMAP queue 3)."""
    n = len(full)
    window_size = params.window_size
    dist_alpha = params.dist.alphabet_size
    lbs = params.literal_byte_score
    use_dict = not params.catable
    # the rows the collectors write from their threads, owned by this
    # call: 0 the deep table's best, 1 its runner-up, 2 the shallow
    # table's best
    lens = np.zeros((3, n), np.int64)
    dists = np.zeros((3, n), np.int64)
    isd = np.zeros((3, n), np.uint8)
    wire = np.zeros((3, n), np.int64)
    score0 = np.zeros(n, np.int64)
    score2 = np.zeros(n, np.int64)
    prog_deep = np.zeros(1, np.int64)
    prog_shal = np.zeros(1, np.int64)
    prog_dict = np.zeros(2, np.int64)
    dict_cap = 6 * n + 64
    dcp, dcl, dcd, dcw = (np.zeros(dict_cap, np.int64) for _ in range(4))
    dci = np.zeros(dict_cap, np.uint8)

    def deep():
        return nb.find_best_matches(
            full, window_size, dict_len=0, literal_byte_score=lbs, k=32,
            bucket_bits=15, k8=0, use_dictionary=False, want_top2=True,
            miss_economy=True,
            out=(lens[0], dists[0], score0, isd[0], wire[0], lens[1],
                 dists[1]),
            progress=prog_deep)

    def shallow():
        return nb.find_best_matches(
            full, window_size, dict_len=0, literal_byte_score=lbs, k=1,
            bucket_bits=17, k8=16, use_dictionary=use_dict,
            miss_economy=True,
            out=(lens[2], dists[2], score2, isd[2], wire[2], None, None),
            progress=prog_shal)

    def dict_pass():
        if not use_dict:
            prog_dict[0] = n
            return 0
        from .static_dict import collect_dict_matches, sorted_dict_index
        sorted_dict_index()
        r = collect_dict_matches(full, 0, window_size, progress=prog_dict,
                                 out=(dcp, dcl, dcd, dcw))
        if r is None:
            # overflow: the search stops short of the region's end, so
            # mark it covered for wait_cover and decline at the end
            prog_dict[0] = n
            return -1
        return len(r[0])

    ex = ThreadPoolExecutor(max_workers=3)
    futs = (ex.submit(deep), ex.submit(shallow), ex.submit(dict_pass))
    ex.shutdown(wait=False)
    try:
        lit_costs = estimate_literal_costs(full)
        lcp = np.concatenate([[0.0], np.cumsum(lit_costs)])

        def wait_cover(hi):
            """Block until every collector's rows cover [0, hi); raise a
            collector's error instead of waiting on it."""
            while min(int(prog_deep[0]), int(prog_shal[0]),
                      int(prog_dict[0])) < hi:
                for f in futs:
                    if f.done():
                        f.result()
                time.sleep(2e-4)

        half = min(max(1 << 16, int(n * _OVERLAP_SEED_FRAC)), n)
        wait_cover(half)
        ext_state = np.full(1, -1, np.int64)

        def extend_chunk(lo, hi):
            # the runner-up row's wire is its length, as in the serial
            # rows (_collect_candidates)
            wire[1, lo:hi] = lens[1, lo:hi]
            hits = np.argwhere((lens[:, lo:hi] >= MATCH_CAP)
                               & (isd[:, lo:hi] == 0))
            if len(hits) == 0:
                return
            hits = hits[np.argsort(hits[:, 1], kind="stable")]
            hc, hp = hits[:, 0], hits[:, 1] + lo
            ext = nb.extend_caps_range(full, 0, hp, dists[hc, hp],
                                       lens[hc, hp], ext_state)
            lens[hc, hp] = ext
            wire[hc, hp] = ext

        extend_chunk(0, half)
        flat = np.argmax(lens[:, :half], axis=0)
        ar = np.arange(half)
        bl = lens[flat, ar]
        bd = dists[flat, ar]
        bs = np.where(bl >= 4, 135 * bl - 30 * np.log2(
            np.maximum(bd, 2)).astype(np.int64), 0)
        pre = greedy_parse(full[:half], bl, bd, bs, [half], 0, 0,
                           initial_cache, isd[flat, ar].astype(bool),
                           window_size, wire[flat, ar])
        p_ins, p_cps, p_dst, p_adv = pre[0]
        pre_cmds, _ = resolve_commands(
            p_ins, p_cps, p_dst, params.dist, advance=p_adv,
            initial_cache=list(initial_cache), pos_offset=0,
            window_size=window_size)
        lh, ch, dh = _histograms_from_commands(full[:half], pre_cmds,
                                               dist_alpha)
        _, cost_cmd, cost_dist = _cost_tables(lh, ch, dh)
        cds = cost_dist[:16].copy()
        cd4 = np.tile(cost_dist, (4, 1))
        cand_off = np.zeros(n + 1, np.int64)
        packed = np.empty(2 * n + 64, nb.ZCAND_DTYPE)
        qstate = np.zeros(18, np.int64)
        dp_state = (np.empty(n + 1, np.float32),
                    *[np.empty(n + 1, np.int32) for _ in range(4)],
                    np.empty(4 * (n + 1), np.int32))
        chunk = 1 << 16
        done = ym_done = 0
        result = None
        while done < n:
            hi = min(done + chunk, n)
            wait_cover(hi)
            if hi > half:  # [0, half) was extended before the seed
                extend_chunk(max(done, half), hi)
            # the dictionary entries emitted so far cover every
            # position below prog_dict[0]
            ym = int(prog_dict[1])
            if ym > ym_done:
                dci[ym_done:ym] = 1
                ym_done = ym
            need = int(cand_off[done]) + int((lens[:, done:hi] >= 2).sum()) \
                + ym
            if need > len(packed):
                grown = np.empty(max(need + 1024, 2 * len(packed)),
                                 nb.ZCAND_DTYPE)
                grown[:int(cand_off[done])] = packed[:int(cand_off[done])]
                packed = grown
            nb.zopfli_cands_dense_range(
                lens, dists, isd, wire, (dcp, dcl, dcd, dci, dcw), ym, n,
                params.dist.npostfix, params.dist.ndirect, cand_off, packed,
                done, hi)
            result = nb.zopfli_dp_cands(
                n, lcp, cost_cmd, cds, cd4, (cand_off, packed), _INS_CODE,
                C.INSERT_EXTRA, _CMD_SYM.reshape(-1),
                _CMD_SYM_LAST.reshape(-1), full, 0, window_size,
                np.asarray(initial_cache, dtype=np.int64),
                n_starts=min(_FINAL_STARTS, 4), cand_cap=_FAST_CAND_CAP,
                max_zopfli_len=150 if params.quality <= 10 else 325,
                p_range=(done, hi), qstate=qstate, state_bufs=dp_state)
            done = hi
        for f in futs[:2]:
            f.result()
        if futs[2].result() < 0:
            return None
        return _finish_parse(n, lcp, *result)
    except BaseException:
        # let every collector finish writing into the rows before they
        # are released, then raise
        for f in futs:
            f.exception()
        raise


def zopfli_segment(full: np.ndarray, params, dict_len: int = 0,
                   initial_cache=(4, 11, 15, 16), iters=None,
                   precollected=None):
    """The commands of one region (data[dict_len:]) by the optimal parse
    with cost-model refinement: iters 1 for the single-iteration tier,
    2 for q10, Q11_ITERS with a convergence stop at q11.  Returns (ins,
    wire, dist, advance).  precollected: zopfli_collect's result for
    this region (the encoder collects one metablock ahead)."""
    n = len(full) - dict_len
    window_size = params.window_size
    dist_alpha = params.dist.alphabet_size
    if iters is None:
        iters = Q11_ITERS if params.quality >= 11 else 2
    # the single-iteration tier seeds its costs from a greedy pre-pass;
    # the refining tiers start from a gentle prior
    use_prior = params.quality >= 10 and iters > 1
    native = nb.available()
    if (precollected is None and dict_len == 0 and iters == 1
            and n >= (1 << 18) and native):
        r = _zopfli_segment_fast_overlapped(full, params, initial_cache)
        if r is not None:
            return r
    col = precollected if precollected is not None else zopfli_collect(
        full, params, dict_len, iters=iters)
    cand_lens = col["cand_lens"]
    cand_dists = col["cand_dists"]
    cand_isdict = col["cand_isdict"]
    cand_wire = col["cand_wire"]
    data_region = full[dict_len:]
    lcp = np.concatenate([[0.0], np.cumsum(col["lit_costs"])])
    if not use_prior:
        flat = np.argmax(cand_lens, axis=0)
        ar = np.arange(n)
        bl = cand_lens[flat, ar]
        bd = cand_dists[flat, ar]
        bs = np.where(bl >= 4, 135 * bl - 30 * np.log2(
            np.maximum(bd, 2)).astype(np.int64), 0)
        pre = greedy_parse(full, bl, bd, bs, [n], dict_len, 0,
                           initial_cache, cand_isdict[flat, ar],
                           window_size, cand_wire[flat, ar])
        p_ins, p_cps, p_dst, p_adv = pre[0]
        pre_cmds, _ = resolve_commands(
            p_ins, p_cps, p_dst, params.dist, advance=p_adv,
            initial_cache=list(initial_cache), pos_offset=dict_len,
            window_size=window_size)
        lh, ch, dh = _histograms_from_commands(data_region, pre_cmds,
                                               dist_alpha)
    result = prepared = prev_end = ctx_mode = None
    it = 0
    last_it = iters - 1  # the final (wide-queue) iteration
    while it <= last_it:
        if it == 0 and use_prior:
            # the reference's prior (set_from_literal_costs, hq.rs:222):
            # small command and distance symbols cheap, large ones dear
            cost_cmd = np.log2(11.0 + np.arange(704))
            cost_dist = np.log2(20.0 + np.arange(dist_alpha,
                                                 dtype=np.float64))
        else:
            _, cost_cmd, cost_dist = _cost_tables(lh, ch, dh)
            if it > 0:
                # literals and distances priced from the previous parse,
                # by the context family the store will use
                if ctx_mode is None:
                    ctx_mode = choose_context_mode(
                        data_region, params.quality, params.mode)
                lc = _context_literal_costs(data_region, full, dict_len,
                                            prev_cmds, mode=ctx_mode)
                lcp = np.concatenate([[0.0], np.cumsum(lc)])
                cost_dist = _context_distance_costs(prev_cmds, dist_alpha)
        cds = (cost_dist[3, :16] if cost_dist.ndim == 2
               else cost_dist[:16]).copy()
        prev = result
        if not native:
            # the edge-list route: the edges are built once and priced
            # each iteration; no cost-based convergence stop
            if prepared is None:
                prepared = _prepare_edges(cand_lens, cand_dists,
                                          cand_isdict, cand_wire,
                                          params.dist, n,
                                          extra=col["extra"])
            result = zopfli_parse(
                n, lcp, cost_cmd, _price_edges(prepared, cost_dist) + (
                    cds, full, dict_len, window_size,
                    np.asarray(initial_cache, dtype=np.int64)))
            end_cost = None
        else:
            result, end_cost, prepared = _dp_native(
                n, lcp, cost_cmd, cds, cost_dist, prepared, col, full,
                dict_len, window_size, initial_cache, params, iters,
                it == last_it)
        if prev is not None and all(
                len(a) == len(b) and np.array_equal(a, b)
                for a, b in zip(result, prev)):
            break
        if it < last_it:
            # when the model-priced parse stops improving, the next
            # iteration is the final one
            if (end_cost is not None and prev_end is not None
                    and prev_end - end_cost <= 2e-4 * abs(end_cost)):
                last_it = it + 1
            prev_end = end_cost
            r_ins, r_cps, r_dst, r_adv = result
            prev_cmds, _ = resolve_commands(
                r_ins, r_cps, r_dst, params.dist, advance=r_adv,
                initial_cache=list(initial_cache), pos_offset=dict_len,
                window_size=window_size)
            lh, ch, dh = _histograms_from_commands(data_region, prev_cmds,
                                                   dist_alpha)
        it += 1
    return result


def _dp_native(n, lcp, cost_cmd, cds, cost_dist, prepared, col, full,
               dict_len, window_size, initial_cache, params, iters, final):
    """One iteration of the runtime's candidate DP, with the candidates
    prepared on the first (prepared None).  Returns (the parse, its
    model cost, prepared)."""
    if prepared is None:
        prepared = nb.zopfli_cands_dense(
            col["cand_lens"], col["cand_dists"], col["cand_isdict"],
            col["cand_wire"], col["extra"], n, params.dist.npostfix,
            params.dist.ndirect)
    if prepared is None:
        # a source out of position order: concatenate and sort
        cand_lens = col["cand_lens"]
        extra = col["extra"]
        ci, ppr = np.nonzero(cand_lens >= 2)
        srcs = [(ppr, cand_lens[ci, ppr], col["cand_dists"][ci, ppr],
                 col["cand_isdict"][ci, ppr], col["cand_wire"][ci, ppr])]
        srcs += [] if extra is None else (
            extra if isinstance(extra, list) else [extra])
        prepared = nb.zopfli_cands(
            *[np.concatenate([s[k] for s in srcs]) for k in range(5)],
            n, params.dist.npostfix, params.dist.ndirect)
    cd4 = (cost_dist if cost_dist.ndim == 2
           else np.tile(cost_dist, (4, 1)))
    # the wide insert-start queue pays only in the final iteration, once
    # the model has converged (the single-iteration tier runs a
    # narrower one)
    cost, ps, pl, pw, pd = nb.zopfli_dp_cands(
        n, lcp, cost_cmd, cds, cd4, prepared, _INS_CODE, C.INSERT_EXTRA,
        _CMD_SYM.reshape(-1), _CMD_SYM_LAST.reshape(-1), full, dict_len,
        window_size, np.asarray(initial_cache, dtype=np.int64),
        n_starts=(min(_FINAL_STARTS, 4) if iters == 1
                  else _FINAL_STARTS) if final else 2,
        cand_cap=((_FAST_CAND_CAP if iters == 1 else 0)
                  if final else _EARLY_CAND_CAP),
        max_zopfli_len=150 if params.quality <= 10 else 325)
    end_cost = (min(float(cost[n]),
                    float((cost[:n] - lcp[:n]).min() + lcp[n]))
                if n else 0.0)
    return _finish_parse(n, lcp, cost, ps, pl, pw, pd), end_cost, prepared
