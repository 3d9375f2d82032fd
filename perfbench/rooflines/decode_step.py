"""Bytes of one launch of the batch decoder's kernel
(csrc/decode_step.cu), from the lanes it is given and the counts it
realized.

A lane decodes the symbol layer of one compressed metablock: it reads
the metablock's bits from `bit0` to the end bit it reports, its three
code-length arrays (256 literal, 704 command and the distance
alphabet's lengths, int32 as the call takes them) and ten int32 words
of state (bit0, length, window, postfix, direct, prefix length, the
four-entry distance ring), and writes its literals (a byte each), its
commands (insert, copy, distance: three int32 each) and eight int32
words (literal and command counts, end bit, status, the ring).
Counted: every byte of that read once and written once.  The decode is
a dependent chain of symbol reads; no operation count is taken, so the
share is the kernel's distance from the bandwidth roof alone.
"""

from __future__ import annotations

LANE_STATE_WORDS = 10
LANE_OUT_WORDS = 8


def lane_bytes(bit0: int, end_bit: int, n_dist_lengths: int, nlit: int,
               ncmd: int) -> int:
    """The bytes one lane reads and writes."""
    stream = (max(end_bit - bit0, 0) + 7) // 8
    lengths = 4 * (256 + 704 + n_dist_lengths)
    return (stream + lengths + 4 * LANE_STATE_WORDS + nlit + 12 * ncmd
            + 4 * LANE_OUT_WORDS)
