"""Depth-limited Huffman code-length construction.

A trimmed copy of brotli_tpu/core/huffman.py: standard Huffman merging
with "flatten and retry" -- if the deepest leaf exceeds the limit, the
minimum count is raised and the tree rebuilt (the reference's
BrotliCreateHuffmanTree scheme).  The code is always Kraft-complete,
which the format requires of every serialized prefix code.
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
