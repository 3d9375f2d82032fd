"""Depth-limited Huffman code-length construction.

A trimmed copy of brotli_tpu/core/huffman.py: standard Huffman merging
with "flatten and retry" -- if the deepest leaf exceeds the limit, the
minimum count is raised and the tree rebuilt (the reference's
BrotliCreateHuffmanTree scheme).  The code is always Kraft-complete,
which the format requires of every serialized prefix code.  The
optimal parser's distance-parameter search costs a symbol stream with
optimize_counts_for_rle and code_bit_cost.
"""

from __future__ import annotations

import heapq

import numpy as np


def _huffman_depths(counts: np.ndarray) -> np.ndarray:
    """Unbounded Huffman: per-symbol depth for symbols with count > 0."""
    n = len(counts)
    syms = np.nonzero(counts)[0]
    heap = [(int(counts[s]), int(s)) for s in syms]
    heapq.heapify(heap)
    parent = {}
    next_id = n
    while len(heap) > 1:
        c1, a = heapq.heappop(heap)
        c2, b = heapq.heappop(heap)
        parent[a] = next_id
        parent[b] = next_id
        heapq.heappush(heap, (c1 + c2, next_id))
        next_id += 1
    root = heap[0][1]
    depths = np.zeros(n, dtype=np.int64)
    # Compute depth of each leaf by walking parents (paths are short).
    memo = {root: 0}

    def depth_of(node):
        path = []
        while node not in memo:
            path.append(node)
            node = parent[node]
        d = memo[node]
        for p in reversed(path):
            d += 1
            memo[p] = d
        return d

    for s in syms:
        depths[s] = depth_of(int(s))
    return depths


def build_huffman_lengths(hist, max_bits: int = 15) -> np.ndarray:
    """Depth-limited Huffman code lengths for a histogram.

    Returns an array of per-symbol code lengths; zero-count symbols get
    length 0.  If only one symbol has nonzero count, it gets the marker
    length 1 (serialized as a single-symbol simple code; emitted with
    0 bits per symbol — see prefix.encoding_table).
    """
    hist = np.asarray(hist, dtype=np.int64)
    lengths = np.zeros(len(hist), dtype=np.int64)
    syms = np.nonzero(hist)[0]
    if len(syms) == 0:
        raise ValueError("empty histogram")
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    count_limit = 1
    while True:
        counts = np.where(hist > 0, np.maximum(hist, count_limit), 0)
        depths = _huffman_depths(counts)
        if int(depths.max()) <= max_bits:
            return depths
        count_limit *= 2


def optimize_counts_for_rle(counts: np.ndarray) -> np.ndarray:
    """Flatten histogram counts so neighboring symbols get equal Huffman
    depths, making the code-length description RLE-friendly (same
    strategy as the reference's BrotliOptimizeHuffmanCountsForRle,
    src/enc/entropy_encode.rs:211: preserve long equal/zero runs, and
    average short strides of near-equal counts)."""
    counts = np.asarray(counts, dtype=np.int64).copy()
    length = len(counts)
    nonzero = int((counts != 0).sum())
    if nonzero < 16:
        return counts
    while length and counts[length - 1] == 0:
        length -= 1
    if length == 0:
        return counts
    nz = counts[:length][counts[:length] != 0]
    if len(nz) < 5:
        return counts
    if nz.min() < 4:
        zeros = length - len(nz)
        if zeros < 6:
            inner = counts[1:length - 1]
            isolated = (counts[:length - 2] != 0) & (inner == 0) \
                & (counts[2:length] != 0)
            inner[isolated] = 1
    if len(nz) < 28:
        return counts

    # mark values already good for RLE (long equal runs)
    good = np.zeros(length + 1, dtype=bool)
    i = 0
    while i < length:
        j = i
        while j < length and counts[j] == counts[i]:
            j += 1
        step = j - i
        if (counts[i] == 0 and step >= 5) or \
                (counts[i] != 0 and step >= 7):
            good[i:j] = True
        i = j

    streak_limit = 1240
    stride = 0
    sum_ = 0
    limit = int(256 * (counts[0] + counts[1] + counts[2]) // 3 + 420)
    for i in range(length + 1):
        boundary = (i == length or good[i]
                    or (i != 0 and good[i - 1])
                    or abs(int(256 * counts[i]) - limit)
                    >= streak_limit) if i < length else True
        if i == length or boundary:
            if stride >= 4 or (stride >= 3 and sum_ == 0):
                count = max(1, (sum_ + stride // 2) // stride)
                if sum_ == 0:
                    count = 0
                counts[i - stride:i] = count
            stride = 0
            sum_ = 0
            if i < length - 2:
                limit = int(256 * (counts[i] + counts[i + 1]
                                   + counts[i + 2]) // 3 + 420)
            elif i < length:
                limit = int(256 * counts[i])
            else:
                limit = 0
        stride += 1
        if i != length:
            sum_ += int(counts[i])
            if stride >= 4:
                limit = (256 * sum_ + stride // 2) // stride
    return counts


def code_bit_cost(hist, lengths) -> int:
    """Total bits to emit `hist` symbols with the given code lengths."""
    hist = np.asarray(hist, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    return int(np.sum(hist * lengths))
