"""A plain reference of the parse that compress_gpu(max_device=True)
commits on the device: one sequential greedy walk, in integers alone,
that imports nothing of the program and nothing of JAX.

Input: one span's fold results, `packed`, the best match at every
position of the span as (length << 26) | distance (a position with no
match holds 0), and `real`, the span's real bytes (the positions past
it are the zero fill of a short last span).  The fold itself is held to
its own plain version (fold_sorted_ref) elsewhere.

The walk, as gpu_path.py's module docstring and ops/parse.py describe
it, over each sub-block of 4096 positions in turn from its first
position i:
  score   135 * len - 30 * floor(log2(max(dist, 1))) where len > 0,
          else 0
  copy    where score > 100 (MIN_SCORE_DELTA): the length cut to the
          sub-block's room (4096 - i % 4096) and to the span's end
          (real - i), and taken if it is >= 2; the walk goes on after it
  literal otherwise: the walk goes on at i + 1
Output: the commands (insert, copy_len, dist), each copy with the
literals before it; literals after the last copy make one more command
(insert, 0, 1), the form the serializer takes for a tail without a copy.

Departures from the description: none in the walk.  The cut at the
span's end is not in ops/parse.py; the program applies it with the
seam's (gpu_path._match_parse_dense), since no copy may run past the
input, and so does this walk.  In a full span the two cuts are one.
"""

from __future__ import annotations

LEN_SHIFT = 26
SUB_BLOCK = 4096
MIN_SCORE_DELTA = 100


def score(length: int, dist: int) -> int:
    """The parse's score of a match (0 where there is none)."""
    if length <= 0:
        return 0
    return 135 * length - 30 * (max(dist, 1).bit_length() - 1)


def commands(lengths, dists, real: int, sub_block: int = SUB_BLOCK,
             scores=None) -> list:
    """The walk over the first `real` positions of a span whose length
    is a multiple of `sub_block`.  `lengths`, `dists` (and `scores`,
    where given in place of score()) are sequences of ints, one a
    position of the span; given scores are taken as they are."""
    n = len(lengths)
    if n % sub_block or not 0 < real <= n:
        raise ValueError(f"plain_parse: {n} positions, real {real}, "
                         f"sub-block {sub_block}")
    out, lit = [], 0
    for b0 in range(0, real, sub_block):
        end = b0 + sub_block
        i = b0
        while i < end and i < real:
            length = lengths[i]
            sc = score(length, dists[i]) if scores is None else scores[i]
            take = (min(length, end - i, real - i) if sc > MIN_SCORE_DELTA
                    else 0)
            if take >= 2:
                out.append((lit, take, dists[i]))
                lit = 0
                i += take
            else:
                lit += 1
                i += 1
    if lit:
        out.append((lit, 0, 1))
    return out


def span_commands(packed, real: int, sub_block: int = SUB_BLOCK) -> list:
    """commands() of one span's packed fold results (a sequence of
    ints)."""
    mask = (1 << LEN_SHIFT) - 1
    packed = list(packed)
    return commands([p >> LEN_SHIFT for p in packed],
                    [p & mask for p in packed], real, sub_block)
