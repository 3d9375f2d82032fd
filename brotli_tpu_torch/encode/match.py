"""LZ77 match finding and the greedy parse of its matches into commands.

find_best_matches: the best (length, distance, score) a position from
two hashed candidate tables and the static dictionary.  greedy_parse:
lazy matching with live distance-cache probes over the per-position
best matches.  Both are the native runtime's (find_matches_native,
greedy_parse_native) where it is in use, else the numpy and Python
forms below, the JAX package's no-runtime routes: every position
hashed in one pass, each position's top-K most recent same-hash
predecessors found by a stable sort (the reference's AdvHasher bucket
x block table, backward_references/mod.rs:932), match lengths by an
8-byte chunk compare over a shrinking active set, and the walk
(reference CreateBackwardReferences, mod.rs:2376-2552).  Scoring
follows the reference: 135*len - 30*floor(log2(dist)), accepted when >
100; the walk defers when the next position scores > cur + 175.
extend_match is the exact extension of one match past the search's
length cap (the runtime's extend_caps does the same for many at once).
"""

from __future__ import annotations

import numpy as np

from .. import native_bridge as nb
from ..core import constants as C

MATCH_CAP = 320  # copy length cap of the search; the walk extends longer
HASH_MUL32 = 0x1E35A7BD
HASH_MUL64 = 0x1FE35A7BD3579BD3
LITERAL_BYTE_SCORE = 540
DISTANCE_BIT_PENALTY = 30
MIN_SCORE_DELTA = 100      # a match is taken iff score - base > this
COST_DIFF_LAZY = 175
MIN_LENGTH = 4
LAST_DISTANCE_BONUS = 15   # flat bonus of a distance-cache match
CACHE_PROBE_SPAN = 16      # short-code candidates the walk probes


def _u32_values(data: np.ndarray) -> np.ndarray:
    """v[i] = the little-endian u32 at byte i (the tail zero-padded)."""
    n = len(data)
    d = np.concatenate([data, np.zeros(4, np.uint8)]).astype(np.uint32)
    return d[:n] | (d[1:n + 1] << 8) | (d[2:n + 2] << 16) | (d[3:n + 3] << 24)


def _u64_values(data: np.ndarray) -> np.ndarray:
    """v[i] = the little-endian u64 at byte i (the tail zero-padded)."""
    n = len(data)
    d = np.concatenate([data, np.zeros(8, np.uint8)]).astype(np.uint64)
    v = d[:n].copy()
    for j in range(1, 8):
        v |= d[j:n + j] << np.uint64(8 * j)
    return v


def hash_positions(data: np.ndarray, bucket_bits: int) -> np.ndarray:
    """The 4-byte hash of every position."""
    v = _u32_values(data)
    return (v * np.uint32(HASH_MUL32)) >> np.uint32(32 - bucket_bits)


def hash_positions5(data: np.ndarray, bucket_bits: int) -> np.ndarray:
    """The 5-byte hash of every position (reference AdvHasher
    hash_len=5, mod.rs:932)."""
    with np.errstate(over="ignore"):
        v = (_u64_values(data) << np.uint64(24)) * np.uint64(HASH_MUL64)
    return (v >> np.uint64(64 - bucket_bits)).astype(np.int64)


def hash_positions_u64(data: np.ndarray, bucket_bits: int) -> np.ndarray:
    """The 8-byte hash of every position (reference H6's 64-bit hash,
    mod.rs:1097): long matches that 4-byte buckets bury."""
    with np.errstate(over="ignore"):
        v = _u64_values(data) * np.uint64(HASH_MUL64)
    return (v >> np.uint64(64 - bucket_bits)).astype(np.int64)


def topk_candidates(h: np.ndarray, k: int) -> np.ndarray:
    """cands[j - 1, i] = the j-th most recent earlier position with
    position i's hash, or -1; shape [k, n]."""
    n = len(h)
    order = np.argsort(h, kind="stable").astype(np.int64)
    h_sorted = h[order]
    cands = np.full((k, n), -1, dtype=np.int64)
    for j in range(1, k + 1):
        same = np.zeros(n, dtype=bool)
        same[j:] = h_sorted[j:] == h_sorted[:-j]
        prev = np.full(n, -1, dtype=np.int64)
        prev[j:] = order[:-j]
        cands[j - 1, order] = np.where(same, prev, -1)
    return cands


def match_lengths(data: np.ndarray, a: np.ndarray, b: np.ndarray,
                  limit: np.ndarray, cap: int = MATCH_CAP) -> np.ndarray:
    """The match length between positions a[i] and b[i] (a < b), capped
    by limit[i] and `cap`: an 8-byte chunk compare over a shrinking
    active set (reference FindMatchLengthWithLimit, static_dict.rs:125)."""
    m = len(a)
    out = np.zeros(m, dtype=np.int64)
    if m == 0:
        return out
    lim = np.minimum(limit, cap)
    d = np.concatenate([data, np.zeros(8, np.uint8)])
    active = np.arange(m)
    off = np.zeros(m, dtype=np.int64)
    r8 = np.arange(8)
    while len(active):
        aa = a[active] + off[active]
        bb = b[active] + off[active]
        neq = d[aa[:, None] + r8] != d[bb[:, None] + r8]
        first = np.where(neq.any(axis=1), neq.argmax(axis=1), 8)
        off[active] += first
        out[active] = np.minimum(off[active], lim[active])
        active = active[(first == 8) & (off[active] < lim[active])]
    return np.minimum(out, lim)


def find_best_matches(data: np.ndarray, window_size: int, k: int = 8,
                      bucket_bits: int = 17, k8: int = 4,
                      bucket_bits8: int = 18, hash_len: int = 4,
                      literal_byte_score: int = 540, dict_len: int = 0,
                      use_dictionary: bool = True, n_cache: int = 4,
                      miss_economy: bool = False):
    """(best_len, best_dist, best_score, best_isdict, best_wire) for the
    positions of data[dict_len:]; data holds a dict_len-byte custom
    dictionary first, whose positions serve only as candidates.
    n_cache, the parse's distance-cache probes, is taken with the other
    quality knobs and not read here; miss_economy backs the scan depth
    off over matchless runs (the optimal parser's collection)."""
    n = len(data)
    if n < 4:
        z = np.zeros(max(0, n - dict_len), dtype=np.int64)
        return (z, z.copy(), z.copy(), np.zeros(len(z), dtype=bool),
                z.copy())
    if nb.available():
        return nb.find_best_matches(
            data, window_size, k=k, bucket_bits=bucket_bits, k8=k8,
            bucket_bits8=bucket_bits8, hash_len=hash_len,
            literal_byte_score=literal_byte_score, dict_len=dict_len,
            use_dictionary=use_dictionary, match_cap=MATCH_CAP,
            miss_economy=miss_economy)
    best_len = np.zeros(n, dtype=np.int64)
    best_dist = np.zeros(n, dtype=np.int64)
    best_score = np.zeros(n, dtype=np.int64)
    best_isdict = np.zeros(n, dtype=bool)
    best_wire = np.zeros(n, dtype=np.int64)  # != best_len only for a
    #                                         dictionary cutoff match
    limit = n - np.arange(n)
    lbs = literal_byte_score // 4
    pos = np.arange(n, dtype=np.int64)
    v = _u32_values(data)

    def fold(cands):
        for c in cands:
            dist = pos - c
            valid = (c >= 0) & (dist <= window_size) & \
                (v[np.maximum(c, 0)] == v)
            idx = np.nonzero(valid)[0]
            if len(idx) == 0:
                continue
            ml = match_lengths(data, c[idx], idx, limit[idx])
            ok = ml >= MIN_LENGTH
            idx = idx[ok]
            ml = ml[ok]
            if len(idx) == 0:
                continue
            sc = (lbs * ml - DISTANCE_BIT_PENALTY *
                  np.floor(np.log2(dist[idx])).astype(np.int64))
            upd = sc > best_score[idx]
            u = idx[upd]
            best_len[u] = ml[upd]
            best_dist[u] = dist[idx][upd]
            best_score[u] = sc[upd]
            best_isdict[u] = False
            best_wire[u] = ml[upd]

    h = (hash_positions5(data, bucket_bits) if hash_len == 5
         else hash_positions(data, bucket_bits))
    fold(topk_candidates(h, k))
    if k8 > 0 and n >= 8:
        fold(topk_candidates(hash_positions_u64(data, bucket_bits8), k8))
    if use_dictionary:
        from .static_dict import add_dictionary_matches
        add_dictionary_matches(data, dict_len, window_size, lbs, best_len,
                               best_dist, best_score, best_isdict,
                               best_wire)
    return (best_len[dict_len:], best_dist[dict_len:],
            best_score[dict_len:], best_isdict[dict_len:],
            best_wire[dict_len:])


def extend_match(data: np.ndarray, cand: int, pos: int, cur_len: int,
                 limit: int) -> int:
    """The exact length of a match of at least cur_len bytes from
    data[pos] against data[cand], up to limit bytes."""
    n = limit
    length = cur_len
    step = 4096
    while length < n:
        t = min(step, n - length)
        x = data[cand + length:cand + length + t]
        y = data[pos + length:pos + length + t]
        neq = x != y
        if neq.any():
            return length + int(neq.argmax())
        length += t
    return length


def score_matches(best_len, best_dist, data=None, base: int = 0,
                  rounds: int = 0, short_fold: bool = False):
    """The walk's scores of a device matcher's best match at each
    position, 135 * len - 30 * floor(log2(max(dist, 2))), 0 where there
    is none.  With `data` (position p at data[base + p]) a length at the
    fold's attested cap of 4 * rounds bytes is first extended exactly in
    place (short_fold: also a length of 8, the short fold's cap; a
    genuine one is a no-op compare), where the runtime is in use:
    without it capped lengths stay capped, as in the JAX package."""
    if data is not None and nb.available():
        capped = best_len >= 4 * rounds
        if short_fold:
            capped |= best_len == 8
        if capped.any():
            pos = np.nonzero(capped)[0]
            best_len[pos] = nb.extend_caps(data, 0, pos + base,
                                           best_dist[pos], best_len[pos])
    return np.where(best_len > 0, LITERAL_BYTE_SCORE // 4 * best_len
                    - DISTANCE_BIT_PENALTY * np.floor(np.log2(np.maximum(
                        best_dist, 2))).astype(np.int64), 0)


def _cache_penalty(i: int) -> int:
    """Reference BackwardReferencePenaltyUsingLastDistance
    (backward_references/mod.rs:1151)."""
    return 39 + ((0x1CA10 >> (i & 0x0E)) & 0x0E)


def _probe_len(data: np.ndarray, src: int, dst: int, limit: int) -> int:
    """A scalar match-length probe, short-biased (its step grows 16,
    64, ... 4096)."""
    if limit <= 0 or data[src] != data[dst]:
        return 0
    step = 16
    length = 0
    while length < limit:
        t = min(step, limit - length)
        neq = data[src + length:src + length + t] \
            != data[dst + length:dst + length + t]
        if neq.any():
            return length + int(neq.argmax())
        length += t
        step = min(step * 4, 4096)
    return length


def greedy_parse(data, best_len, best_dist, best_score, boundaries,
                 dict_len: int = 0, pos0: int = 0,
                 initial_cache=(4, 11, 15, 16), best_isdict=None,
                 window_size: int = 1 << 62, best_wire=None):
    """Segments of (insert[], wire_copy[], distance[], advance[]), one
    per boundary; advance != wire_copy only for dictionary cutoff
    transforms.  The native walk where the runtime is in use, else
    greedy_parse_py."""
    if nb.available():
        return nb.greedy_parse(data, best_len, best_dist, best_score,
                               boundaries, dict_len, pos0, initial_cache,
                               best_isdict, window_size, best_wire)
    return greedy_parse_py(data, best_len, best_dist, best_score,
                           boundaries, dict_len, pos0, initial_cache,
                           best_isdict, window_size, best_wire)


def greedy_parse_py(data, best_len, best_dist, best_score, boundaries,
                    dict_len: int = 0, pos0: int = 0,
                    initial_cache=(4, 11, 15, 16), best_isdict=None,
                    window_size: int = 1 << 62, best_wire=None):
    """The greedy walk with lazy matching and distance-cache reuse
    (reference CreateBackwardReferences, mod.rs:2376-2552; a cache
    candidate is scored with the flat last-distance bonus less its
    short-code penalty, mod.rs:1720-1740, 1871-1876).  The cache
    follows the RFC (push-front on every distance code but 0), so every
    cache hit resolves to a short code in command.resolve_commands.

    data: a dict_len-byte prefix, then the input; best_* index the
    input (0 == absolute dict_len).  boundaries: sorted input positions
    where commands must end (metablock ends and the input's end).
    Returns lists a segment, as greedy_parse."""
    n = len(data) - dict_len
    bl, bd, bs = best_len, best_dist, best_score
    isd = best_isdict if best_isdict is not None \
        else np.zeros(len(bs), dtype=bool)
    bw = best_wire if best_wire is not None else bl
    pos = pos0
    insert_start = pos0
    segments = []
    lbs = LITERAL_BYTE_SCORE // 4
    cache = list(initial_cache)
    short_idx = C.DISTANCE_SHORT_CODE_INDEX.tolist()
    short_delta = C.DISTANCE_SHORT_CODE_DELTA.tolist()

    def cached_match(q, boundary):
        """The best (len, dist, score) over the short-code distances
        cache[idx] + delta (RFC 7932 section 4)."""
        limit = min(boundary, n) - q
        best = (0, 0, 0)
        for i in range(CACHE_PROBE_SPAN):
            d = cache[short_idx[i]] + short_delta[i]
            # the +-3 deltas can reach past the window, where the
            # distance would decode as a dictionary reference (the
            # native search clamps alike)
            if d <= 0 or d > dict_len + q or d > window_size:
                continue
            lc = _probe_len(data, dict_len + q - d, dict_len + q, limit)
            if lc >= 4:
                sc = lbs * lc + LAST_DISTANCE_BONUS
                if i != 0:
                    sc -= _cache_penalty(i)
                if sc > best[2]:
                    best = (lc, d, sc)
        return best

    def candidate(q, boundary):
        # max(the table's best, a live distance-cache probe), at every
        # position (the in-line search walk's shape)
        lc, dc, csc = cached_match(q, boundary)
        tsc = int(bs[q])
        if csc >= tsc and csc > 0:
            return csc, lc, dc, lc, False
        return tsc, int(bl[q]), int(bd[q]), int(bw[q]), bool(isd[q])

    for boundary in boundaries:
        ins, cps, dst, adv = [], [], [], []
        misses = 0
        while pos + 2 <= boundary:
            s, ln, d, wire, dict_ref = candidate(pos, boundary)
            if s <= MIN_SCORE_DELTA:
                step = 4 if misses > 512 else 2 if misses > 64 else 1
                misses += 1
                pos += step
                continue
            defers = 0
            while defers < 4 and pos + 1 + 4 <= boundary:
                s2, l2, d2, w2, dr2 = candidate(pos + 1, boundary)
                if s2 <= s + COST_DIFF_LAZY:
                    break
                pos += 1
                s, ln, d, wire, dict_ref = s2, l2, d2, w2, dr2
                defers += 1
            misses = 0
            if not dict_ref and ln >= MATCH_CAP:
                ln = extend_match(data, dict_len + pos - d, dict_len + pos,
                                  ln, n - pos)
                wire = ln
            if pos + ln > boundary:
                if dict_ref:  # a dictionary word cannot be cut
                    pos += 1
                    continue
                ln = wire = boundary - pos
                if ln < 2:
                    pos += 1
                    continue
            ins.append(pos - insert_start)
            cps.append(wire if dict_ref else ln)
            dst.append(d)
            adv.append(ln)
            # as resolve_commands: dictionary references (beyond
            # max_distance) and distance code 0 leave the cache alone
            if d <= min(dict_len + pos, window_size) and d != cache[0]:
                cache.pop()
                cache.insert(0, d)
            pos += ln
            insert_start = pos
        if boundary > insert_start or not ins:
            ins.append(boundary - insert_start)
            cps.append(0)
            dst.append(0)
            adv.append(0)
        insert_start = boundary
        pos = max(pos, boundary)
        segments.append((ins, cps, dst, adv))
    return segments
