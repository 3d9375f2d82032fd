"""Encoder-side static dictionary matching (vectorized, host).

A copy of brotli_tpu/encode/static_dict.py.  The greedy
tiers' index is built once from the RFC dictionary and probed for all
positions in one pass: hash the 4-byte prefix at every position,
gather the bucket's candidate words, verify with a masked [n, 24] byte
compare.  A reference encodes as distance = max_distance + 1 + word_id
(RFC 8), with the identity or an OmitLast transform.

The optimal parser takes every transform: collect_dict_matches returns
all dictionary matches of a region through the runtime's predecessor
search over the sorted index of every (word x transform) output
(sorted_dict_index), or, where the runtime is not in use, the same
search in numpy (an exact-key probe of the index for every output
length).  expanded_dict_index is the same set of outputs hashed by
their 4-byte prefix, for the runtime's hashed collector
(native_bridge.collect_dict) and the numpy builder of the sorted index.
collect_dict_matches_identity is the identity and OmitLast matches of
the greedy tiers' index as sparse candidates.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .. import native_bridge as nb
from ..core.dictionary import OMIT_LAST_1, apply_transform, get_dictionary

HASH_MUL32 = 0x1E35A7BD
DICT_HASH_BITS = 15
DICT_SLOTS = 2
MAX_WORD_LEN = 24
DISTANCE_BIT_PENALTY = 30
PROBE_CHUNK = 1 << 20   # positions per [chunk, 24] byte-window gather


@lru_cache(maxsize=1)
def dict_index():
    """(word_bytes[n_entries, 24], word_len[n], word_idx[n], table
    [2^bits, slots] of entry ids (-1 empty), size_bits[25])."""
    d = get_dictionary()
    data = np.frombuffer(d.data, dtype=np.uint8)
    entries_len = []
    entries_idx = []
    entries_off = []
    for length in range(4, MAX_WORD_LEN + 1):
        nwords = d.num_words(length)
        if nwords == 0:
            continue
        off = int(d.offsets_by_length[length])
        idx = np.arange(nwords, dtype=np.int64)
        entries_len.append(np.full(nwords, length, dtype=np.int64))
        entries_idx.append(idx)
        entries_off.append(off + idx * length)
    word_len = np.concatenate(entries_len)
    word_idx = np.concatenate(entries_idx)
    word_off = np.concatenate(entries_off)
    m = len(word_len)

    # padded word byte matrix [m, 24]
    gather = word_off[:, None] + np.arange(MAX_WORD_LEN)[None, :]
    gather = np.minimum(gather, len(data) - 1)
    word_bytes = data[gather]

    # 4-byte-prefix hash table
    p = data[word_off[:, None] + np.arange(4)[None, :]].astype(np.uint32)
    v = p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16) | (p[:, 3] << 24)
    h = ((v * np.uint32(HASH_MUL32)) >> np.uint32(32 - DICT_HASH_BITS)) \
        .astype(np.int64)
    table = np.full((1 << DICT_HASH_BITS, DICT_SLOTS), -1, dtype=np.int64)
    fill = np.zeros(1 << DICT_HASH_BITS, dtype=np.int64)
    # iterate lengths ascending: slot 0 = shortest candidate per bucket
    for e in range(m):
        b = h[e]
        f = fill[b]
        if f < DICT_SLOTS:
            table[b, f] = e
            fill[b] = f + 1

    size_bits = np.zeros(MAX_WORD_LEN + 1, dtype=np.int64)
    for length in range(4, MAX_WORD_LEN + 1):
        size_bits[length] = int(d.size_bits_by_length[length])
    return word_bytes, word_len, word_idx, table, size_bits


@lru_cache(maxsize=1)
def omit_last_transform_ids():
    """Transform id of the bare ('', OmitLast_k, '') transform per k
    (RFC Appendix B); index 0 = identity."""
    d = get_dictionary()
    ids = np.full(10, -1, dtype=np.int64)
    ids[0] = 0
    for t in range(len(d.t_type)):
        ty = d.t_type[t]
        if d.t_prefix[t] == b"" and d.t_suffix[t] == b"" \
                and OMIT_LAST_1 <= ty <= OMIT_LAST_1 + 8:
            ids[ty - OMIT_LAST_1 + 1] = t
    return ids


def add_dictionary_matches(data: np.ndarray, dict_len: int,
                           window_size: int, lbs: int,
                           best_len: np.ndarray, best_dist: np.ndarray,
                           best_score: np.ndarray, best_isdict: np.ndarray,
                           best_wire: np.ndarray):
    """Union static-dictionary matches into the per-position best arrays
    (in place): full-word identity matches plus cutoff (OmitLast_k)
    partial matches.  A prefix match of m of the word's L bytes
    encodes as transform omit_last_(L-m) with wire copy length L and
    output m."""
    word_bytes, word_len, word_idx, table, size_bits = dict_index()
    omit_ids = omit_last_transform_ids()
    n = len(data)
    if n < 4:
        return
    d32 = np.concatenate([data, np.zeros(4, np.uint8)]).astype(np.uint32)
    v = d32[:n] | (d32[1:n + 1] << 8) | (d32[2:n + 2] << 16) \
        | (d32[3:n + 3] << 24)
    h = ((v * np.uint32(HASH_MUL32)) >> np.uint32(32 - DICT_HASH_BITS)) \
        .astype(np.int64)
    pad = np.concatenate([data, np.zeros(MAX_WORD_LEN, np.uint8)])
    span = np.arange(MAX_WORD_LEN)

    for c0 in range(dict_len, n, PROBE_CHUNK):
        c1 = min(c0 + PROBE_CHUNK, n)
        idx = np.arange(c0, c1, dtype=np.int64)
        window = pad[idx[:, None] + span[None, :]]   # [m, 24]
        for slot in range(DICT_SLOTS):
            e = table[h[c0:c1], slot]
            hit = e >= 0
            if not hit.any():
                continue
            ee = np.maximum(e, 0)
            L = word_len[ee]
            eq = window == word_bytes[ee]
            cmp_ok = np.cumprod(eq, axis=1, dtype=bool)
            mlen = np.minimum(cmp_ok.sum(axis=1), L)
            mlen = np.minimum(mlen, n - idx)  # clamp to available input
            omit = L - mlen
            valid_t = (omit == 0) | ((omit <= 9) &
                                     (omit_ids[np.minimum(omit, 9)] >= 0))
            ok = hit & (mlen >= 4) & valid_t
            if not ok.any():
                continue
            sel = np.nonzero(ok)[0]
            pos = idx[sel]
            m = mlen[sel]
            Ls = L[sel]
            transform = omit_ids[Ls - m]
            max_dist = np.minimum(pos, window_size)
            wid = (transform << size_bits[Ls]) + word_idx[ee[sel]]
            dist = max_dist + 1 + wid
            sc = (lbs * m - DISTANCE_BIT_PENALTY *
                  np.floor(np.log2(dist)).astype(np.int64))
            upd = sc > best_score[pos]
            u = pos[upd]
            best_len[u] = m[upd]
            best_dist[u] = dist[upd]
            best_score[u] = sc[upd]
            best_isdict[u] = True
            best_wire[u] = Ls[upd]


EXT_HASH_BITS = 20
EXT_SLOTS = 12
EXT_MAX_OUT = 38


@lru_cache(maxsize=1)
def expanded_dict_index():
    """Every (word x transform) output of 4 to EXT_MAX_OUT bytes, keyed
    by the 4-byte prefix of the transformed output, so case and affix
    variants are found by the probe that finds identity matches (the
    reference's transform-aware search, BrotliFindAllStaticDictionary
    Matches, hand-tests each transform class instead).  Returns
    (entry_bytes[m, 38], out_len[m], wire[m], wid[m], table[2^20, 12]);
    a bucket keeps its EXT_SLOTS shortest entries."""
    d = get_dictionary()
    data = np.frombuffer(d.data, dtype=np.uint8)
    eb, eo, ew, ewid = [], [], [], []
    for length in range(4, MAX_WORD_LEN + 1):
        nwords = d.num_words(length)
        if nwords == 0:
            continue
        off = int(d.offsets_by_length[length])
        bits = int(d.size_bits_by_length[length])
        words = [bytes(data[off + i * length: off + (i + 1) * length])
                 for i in range(nwords)]
        for t in range(len(d.t_type)):
            for i, w in enumerate(words):
                out = apply_transform(d, w, t)
                if 4 <= len(out) <= EXT_MAX_OUT:
                    eb.append(out)
                    eo.append(len(out))
                    ew.append(length)
                    ewid.append((t << bits) | i)
    m = len(eb)
    entry_bytes = np.zeros((m, EXT_MAX_OUT), dtype=np.uint8)
    for i, out in enumerate(eb):
        entry_bytes[i, :len(out)] = np.frombuffer(out, np.uint8)
    out_len = np.asarray(eo, dtype=np.int64)
    wire = np.asarray(ew, dtype=np.int64)
    wid = np.asarray(ewid, dtype=np.int64)
    v = (entry_bytes[:, 0].astype(np.uint32)
         | (entry_bytes[:, 1].astype(np.uint32) << 8)
         | (entry_bytes[:, 2].astype(np.uint32) << 16)
         | (entry_bytes[:, 3].astype(np.uint32) << 24))
    h = ((v * np.uint32(HASH_MUL32))
         >> np.uint32(32 - EXT_HASH_BITS)).astype(np.int64)
    order = np.lexsort((out_len, h))
    hs = h[order]
    rank = np.arange(m) - np.searchsorted(hs, hs, side="left")
    keep = rank < EXT_SLOTS
    table = np.full((1 << EXT_HASH_BITS, EXT_SLOTS), -1, dtype=np.int32)
    table[hs[keep], rank[keep]] = order[keep].astype(np.int32)
    return entry_bytes, out_len, wire, wid, table


@lru_cache(maxsize=1)
def sorted_dict_index():
    """Every unique transformed output, sorted by its 0-padded bytes and
    then its length, each kept at its cheapest encoding (the least word
    id): (sorted_bytes[m, 38], out_len, wire, wid), row-aligned.  The
    runtime builds it (zopfli_hq.cpp build_sorted_index) where it is in
    use; the numpy builder below gives the same rows."""
    if nb.available():
        return nb.sorted_dict_index_native()
    entry_bytes, out_len, wire, wid, _ = expanded_dict_index()
    kv = _sort_keys(entry_bytes, out_len)
    order = np.lexsort((wid, kv))
    kv_s = kv[order]
    first = np.ones(len(kv), bool)
    first[1:] = kv_s[1:] != kv_s[:-1]
    sel = order[first]  # the least-wid entry of a key, still key-sorted
    return (np.ascontiguousarray(entry_bytes[sel]), out_len[sel].copy(),
            wire[sel].copy(), wid[sel].copy())


def _sort_keys(entry_bytes: np.ndarray, out_len: np.ndarray) -> np.ndarray:
    """The index's sort keys as byte strings: the 0-padded output, then
    its length (which keeps the key free of a trailing NUL, so the
    S-dtype's memcmp order is exact)."""
    keys = np.zeros((len(out_len), EXT_MAX_OUT + 1), np.uint8)
    keys[:, :EXT_MAX_OUT] = entry_bytes
    keys[:, EXT_MAX_OUT] = out_len
    return np.ascontiguousarray(keys).view(f"S{EXT_MAX_OUT + 1}").ravel()


def collect_dict_matches(data: np.ndarray, dict_len: int, window_size: int,
                         progress=None, out=None, chunk: int = 1 << 15):
    """Every static-dictionary match (every transform) of data[dict_len:]
    as sparse candidates for the optimal parser: (pos, out_len,
    pseudo_dist, wire), pos relative to the region's start, sorted by
    position.  The DP prices each against window matches and literals
    (reference hq.rs:707).  progress and out: see
    native_bridge.collect_dict_sorted (None where `out` overflows); the
    numpy search, where the runtime is not in use, takes neither and
    probes `chunk` positions at a time."""
    n = len(data)
    if n - dict_len < 4:
        return (np.zeros(0, np.int64),) * 4
    if nb.available():
        return nb.collect_dict_sorted(data, dict_len, window_size,
                                      progress=progress, out=out)
    sb, s_len, s_wire, s_wid = sorted_dict_index()
    m = len(s_len)
    kv = _sort_keys(sb, s_len)
    pad = np.concatenate([data, np.zeros(EXT_MAX_OUT, np.uint8)])
    out_p, out_l, out_d, out_w = [], [], [], []
    for c0 in range(dict_len, n - 3, chunk):
        idx = np.arange(c0, min(c0 + chunk, n - 3), dtype=np.int64)
        win = pad[idx[:, None] + np.arange(EXT_MAX_OUT)[None, :]]
        q = np.zeros((len(idx), EXT_MAX_OUT + 1), np.uint8)
        for length in np.unique(s_len).tolist():
            # the window's first `length` bytes and the length byte form
            # a whole key iff an output with those bytes exists (the
            # keys are unique)
            q[:, :length] = win[:, :length]
            q[:, length:EXT_MAX_OUT] = 0
            q[:, EXT_MAX_OUT] = length
            qv = np.ascontiguousarray(q).view(
                f"S{EXT_MAX_OUT + 1}").ravel()
            at = np.searchsorted(kv, qv)
            ok = (at < m) & (kv[np.minimum(at, m - 1)] == qv) \
                & (idx + length <= n)
            if not ok.any():
                continue
            sel = np.nonzero(ok)[0]
            e = at[sel]
            pos = idx[sel]
            out_p.append(pos - dict_len)
            out_l.append(np.full(len(sel), length, np.int64))
            out_d.append(np.minimum(pos, window_size) + 1 + s_wid[e])
            out_w.append(s_wire[e])
    if not out_p:
        return (np.zeros(0, np.int64),) * 4
    res = tuple(np.concatenate(a) for a in (out_p, out_l, out_d, out_w))
    order = np.argsort(res[0], kind="stable")
    return tuple(a[order] for a in res)


def collect_dict_matches_identity(data: np.ndarray, dict_len: int,
                                  window_size: int, chunk: int = 1 << 20):
    """The identity and OmitLast matches of the greedy tiers' index
    (dict_index) as sparse candidates: (pos, out_len, pseudo_dist,
    wire), pos relative to the region's start.  Unlike
    add_dictionary_matches it keeps every match, not only one that
    beats the window's: the optimal parser prices both (reference
    hq.rs:1237)."""
    word_bytes, word_len, word_idx, table, size_bits = dict_index()
    omit_ids = omit_last_transform_ids()
    n = len(data)
    if n < 4:
        return (np.zeros(0, np.int64),) * 4
    d32 = np.concatenate([data, np.zeros(4, np.uint8)]).astype(np.uint32)
    v = d32[:n] | (d32[1:n + 1] << 8) | (d32[2:n + 2] << 16) \
        | (d32[3:n + 3] << 24)
    h = ((v * np.uint32(HASH_MUL32)) >> np.uint32(32 - DICT_HASH_BITS)) \
        .astype(np.int64)
    pad = np.concatenate([data, np.zeros(MAX_WORD_LEN, np.uint8)])
    span = np.arange(MAX_WORD_LEN)
    out_p, out_l, out_d, out_w = [], [], [], []
    for c0 in range(dict_len, n, chunk):
        c1 = min(c0 + chunk, n)
        idx = np.arange(c0, c1, dtype=np.int64)
        window = pad[idx[:, None] + span[None, :]]
        for slot in range(DICT_SLOTS):
            e = table[h[c0:c1], slot]
            hit = e >= 0
            if not hit.any():
                continue
            ee = np.maximum(e, 0)
            wl = word_len[ee]
            cmp_ok = np.cumprod(window == word_bytes[ee], axis=1, dtype=bool)
            mlen = np.minimum(np.minimum(cmp_ok.sum(axis=1), wl), n - idx)
            omit = wl - mlen
            valid_t = (omit == 0) | ((omit <= 9) &
                                     (omit_ids[np.minimum(omit, 9)] >= 0))
            ok = hit & (mlen >= 4) & valid_t
            if not ok.any():
                continue
            sel = np.nonzero(ok)[0]
            pos = idx[sel]
            m = mlen[sel]
            ls = wl[sel]
            wid = (omit_ids[ls - m] << size_bits[ls]) + word_idx[ee[sel]]
            out_p.append(pos - dict_len)
            out_l.append(m)
            out_d.append(np.minimum(pos, window_size) + 1 + wid)
            out_w.append(ls)
    if not out_p:
        return (np.zeros(0, np.int64),) * 4
    return tuple(np.concatenate(a) for a in (out_p, out_l, out_d, out_w))
