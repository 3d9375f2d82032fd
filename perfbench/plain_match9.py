"""A plain reference of compress_gpu's q9 matcher (the exact9 tier: two
folds over content-sorted rows, their merge on the host, the exact
extension of capped lengths), in numpy alone; it imports nothing of the
program and nothing of JAX.

Input: one span's row (uint8: up to `halo` bytes before the span, the
span at [halo:], zero fill past a short last span), `min_pos` (the
row's first byte of data; the zero fill below it is no match source),
`halo`, `window_size` and `real` (the span's bytes).  Output, at each of
the span's real positions p (row positions halo ... halo + real - 1):
the match (len, dist), and whether it came from the short fold.

The semantics, as ops/fold_cuda.py's wrappers, csrc/fold.cu, the host's
invert_merge32 and extend_caps state them, over the row's positions,
its bytes read past the row's end as 0:
  words       v0(i), v1(i): the 4 bytes at i and at i + 4 as
              little-endian u32
  main fold   the row's positions in a stable sort by unsigned
              (v0, v1); the candidates of p are the positions 1 ... 16
              places before it and 1 ... 8 places after it, in that
              order
  short fold  a stable sort by v0 read as a signed int32; the positions
              1 ... 16 places before p
  candidate   c with v0(c) == v0(p), 0 < p - c <= window_size and
              c >= min_pos; its length is the common prefix of the
              bytes at p and at c, at most 16 (main) or 8 (short) and at
              most the row's end less p; under 4 it is no candidate
  score       135 * len - 30 * floor(log2(p - c)); a fold keeps the
              first candidate, in the order above, whose score is
              strictly the highest (none above 0: no match); a best
              score <= 100 is no match, (len, dist, score) = (0, 0, 0)
  merge       the short fold's match where its score strictly beats the
              main fold's
  extension   a length of 16 (the main fold's cap) or of 8 (the short
              fold's) is followed on byte by byte up to the span's last
              real byte, position by position in order, except at a
              position more than 32 bytes before the end of the longest
              extension so far, which keeps its length (extend_caps'
              skip)

Departures from that description: none.  Two points it leaves to the
reader, followed here as the program has them: a length is counted to
the row's end, so past a short last span's real bytes the zero fill
counts as bytes (the greedy walk cuts every copy at the span's end, so
no stream holds such a copy); and the extension compares bytes only up
to the span's last real byte, so a length already past it stays as it
is.
"""

from __future__ import annotations

import numpy as np

LBS = 135          # the literal byte score, 540 / 4
PENALTY = 30       # a distance bit's cost
MIN_SCORE = 100    # a best score at or under it is no match
MAIN_CAP, MAIN_FWD, MAIN_BACK = 16, 16, 8
SHORT_CAP, SHORT_FWD = 8, 16
SKIP = 32          # extend_caps' skip behind the longest extension


def _words(row: np.ndarray, width: int, offset: int = 0) -> np.ndarray:
    """The little-endian unsigned word of `width` bytes at i + offset for
    every row position i, the bytes past the row's end read as 0."""
    buf = np.zeros(len(row) + 16, np.uint8)
    buf[:len(row)] = row
    return np.ndarray((len(row),), dtype="<u%d" % width, buffer=buf,
                      offset=offset, strides=(1,)).copy()


def _low_zero_bytes(x: np.ndarray) -> np.ndarray:
    """The equal leading bytes a xor of two little-endian u64 words
    shows: its zero bytes from the low end (8 where it is 0)."""
    out = np.full(x.shape, 8, np.int64)
    for b in range(7, -1, -1):
        out[(x >> np.uint64(8 * b)) & np.uint64(0xFF) != 0] = b
    return out


def _fold(order, inv, v0, p, lo, hi, cap, fwd, back, window_size,
          min_pos, n):
    """One fold at positions p: (len, dist, score), gated."""
    r = inv[p]
    best = np.zeros(len(p), np.int64)
    blen = np.zeros(len(p), np.int64)
    bdist = np.zeros(len(p), np.int64)
    for j in list(range(1, fwd + 1)) + [-j for j in range(1, back + 1)]:
        s = r - j
        inside = (s >= 0) & (s < n)
        c = order[np.clip(s, 0, n - 1)]
        dist = p - c
        ok = inside & (v0[c] == v0[p]) & (dist > 0) \
            & (dist <= window_size) & (c >= min_pos)
        x = lo[p] ^ lo[c]
        common = _low_zero_bytes(x)
        more = x == 0
        common[more] += _low_zero_bytes(hi[p[more]] ^ hi[c[more]])
        length = np.minimum(np.minimum(common, cap), n - p)
        ok &= length >= 4
        logd = np.frexp(np.maximum(dist, 1).astype(np.float64))[1] - 1
        score = LBS * length - PENALTY * logd
        take = ok & (score > best)
        best = np.where(take, score, best)
        blen = np.where(take, length, blen)
        bdist = np.where(take, dist, bdist)
    gate = best > MIN_SCORE
    return (np.where(gate, blen, 0), np.where(gate, bdist, 0),
            np.where(gate, best, 0))


def _probe(data: bytes, src: int, dst: int, limit: int) -> int:
    """The equal bytes at src and dst, at most `limit`."""
    if limit <= 0 or data[src] != data[dst]:
        return 0
    n = 0
    while n < limit:
        t = min(64, limit - n)
        a, b = data[src + n:src + n + t], data[dst + n:dst + n + t]
        if a != b:
            return n + next(k for k in range(t) if a[k] != b[k])
        n += t
    return n


def extend(row: np.ndarray, halo: int, real: int, lengths, dists):
    """The lengths after extend_caps at the span's real positions (a
    copy; `lengths` and `dists` one a real position)."""
    data = row[:halo + real].tobytes()
    end = len(data)
    out = np.array(lengths, np.int64)
    last_end = -1
    capped = (out >= MAIN_CAP) | (out == SHORT_CAP)
    for i in np.nonzero(capped)[0].tolist():
        p, d, ln = halo + i, int(dists[i]), int(out[i])
        if p < last_end - SKIP:
            continue
        ext = ln + _probe(data, p - d + ln, p + ln, end - p - ln)
        out[i] = ext
        last_end = max(last_end, p + ext)
    return out


def folds(row, min_pos: int, halo: int, window_size: int, real: int):
    """The two folds' (len, dist, score) at the span's real positions,
    the main fold's first: int64 arrays of `real` entries, gated."""
    row = np.asarray(row, np.uint8)
    n = len(row)
    if not 0 < real <= n - halo:
        raise ValueError(f"plain_match9: {n} row bytes, halo {halo}, "
                         f"real {real}")
    v0, v1 = _words(row, 4), _words(row, 4, 4)
    lo, hi = _words(row, 8), _words(row, 8, 8)
    p = np.arange(halo, halo + real, dtype=np.int64)
    out = []
    for key, cap, fwd, back in (
            ((v0.astype(np.uint64) << np.uint64(32)) | v1, MAIN_CAP,
             MAIN_FWD, MAIN_BACK),
            (v0.view(np.int32), SHORT_CAP, SHORT_FWD, 0)):
        order = np.argsort(key, kind="stable")
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        out.append(_fold(order, inv, v0, p, lo, hi, cap, fwd, back,
                         window_size, min_pos, n))
    return out


def span_matches(row, min_pos: int, halo: int, window_size: int,
                 real: int):
    """(len, dist, short, tie) at the span's real positions: int64,
    int64, bool and bool arrays of `real` entries; short where the
    merged match came from the short fold, tie where the two folds'
    scores were equal and above 0 (the main fold's match kept)."""
    (ml, md, ms), (sl, sd, ss) = folds(row, min_pos, halo, window_size,
                                       real)
    short = ss > ms
    lengths = np.where(short, sl, ml)
    dists = np.where(short, sd, md)
    return (extend(np.asarray(row, np.uint8), halo, real, lengths, dists),
            dists, short, (ss == ms) & (ms > 0))
