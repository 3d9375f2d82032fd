"""LZ77 match finding and the greedy parse of its matches into commands.

Both are the native runtime's.  find_best_matches: best (length,
distance, score) per position from two hashed candidate tables and the
static dictionary (find_matches_native).  greedy_parse: lazy matching
with live distance-cache probes over per-position best matches
(greedy_parse_native).  Scoring follows the reference: 135*len -
30*floor(log2(dist)), accepted when > 100.  extend_match is the exact
extension of one match past the search's length cap, in numpy (the
runtime's extend_caps does the same for many at once).
"""

from __future__ import annotations

import numpy as np

from .. import native_bridge as nb

MATCH_CAP = 320  # copy length cap of the search; the walk extends longer


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
    return nb.find_best_matches(
        data, window_size, k=k, bucket_bits=bucket_bits, k8=k8,
        bucket_bits8=bucket_bits8, hash_len=hash_len,
        literal_byte_score=literal_byte_score, dict_len=dict_len,
        use_dictionary=use_dictionary, match_cap=MATCH_CAP,
        miss_economy=miss_economy)


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


def greedy_parse(data, best_len, best_dist, best_score, boundaries,
                 dict_len: int, pos0: int, initial_cache, best_isdict,
                 window_size: int, best_wire):
    """Segments of (insert[], wire_copy[], distance[], advance[]), one
    per boundary; advance != wire_copy only for dictionary cutoff
    transforms."""
    return nb.greedy_parse(data, best_len, best_dist, best_score,
                           boundaries, dict_len, pos0, initial_cache,
                           best_isdict, window_size, best_wire)
