"""Canonical prefix (Huffman) codes: code assignment and the writer.

A trimmed copy of brotli_tpu/core/prefix.py (RFC 7932 section 3):
canonical codes (3.2), simple prefix codes (3.4) and complex prefix
codes with the code-length code and RLE repeats (3.5), as written by
the encoder.
"""

from __future__ import annotations

import numpy as np

from .constants import (CLCODE_BITS, CLCODE_NBITS, CODE_LENGTH_CODE_ORDER,
                        MAX_HUFF_BITS)
from .huffman import build_huffman_lengths


def bit_reverse(v: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Reverse the low `nbits` bits of each value (vectorized)."""
    v = np.asarray(v, dtype=np.uint32)
    # Full 16-bit reverse then shift down (codes are at most 15 bits).
    x = v.astype(np.uint32)
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    r = x >> (16 - np.asarray(nbits, dtype=np.uint32))
    return np.where(np.asarray(nbits) == 0, 0, r).astype(np.uint32)


def lengths_to_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code assignment (RFC 7932 3.2), returned LSB-first.

    Returns an array of code bit patterns such that writing
    (codes[s], lengths[s]) LSB-first emits the canonical code for s.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    codes = np.zeros_like(lengths)
    count = np.bincount(lengths, minlength=MAX_HUFF_BITS + 1)
    count[0] = 0
    next_code = np.zeros(MAX_HUFF_BITS + 2, dtype=np.int64)
    code = 0
    for l in range(1, MAX_HUFF_BITS + 1):
        code = (code + count[l - 1]) << 1
        next_code[l] = code
    for l in range(1, MAX_HUFF_BITS + 1):
        syms = np.nonzero(lengths == l)[0]
        if len(syms):
            codes[syms] = next_code[l] + np.arange(len(syms))
    return bit_reverse(codes, np.maximum(lengths, 0)).astype(np.int64)


def _alphabet_bits(alphabet_size: int) -> int:
    return max(1, (alphabet_size - 1).bit_length())


def write_prefix_code(writer, lengths: np.ndarray):
    """Serialize a prefix code given per-symbol code lengths."""
    lengths = np.asarray(lengths, dtype=np.int64)
    syms = np.nonzero(lengths > 0)[0]
    nsym = len(syms)
    if nsym == 0:
        raise ValueError("cannot serialize empty code")
    alphabet_size = len(lengths)
    if nsym <= 4 and _is_simple_shape(lengths, syms):
        _write_simple(writer, lengths, syms, alphabet_size)
    else:
        _write_complex(writer, lengths)


def _is_simple_shape(lengths, syms) -> bool:
    ls = sorted(int(lengths[s]) for s in syms)
    n = len(syms)
    return ((n == 1) or
            (n == 2 and ls == [1, 1]) or
            (n == 3 and ls == [1, 2, 2]) or
            (n == 4 and ls in ([2, 2, 2, 2], [1, 2, 3, 3])))


def _write_simple(writer, lengths, syms, alphabet_size):
    writer.write(1, 2)  # HSKIP == 1 => simple
    nsym = len(syms)
    writer.write(nsym - 1, 2)
    bits = _alphabet_bits(alphabet_size)
    # Order symbols by (length, symbol) to match canonical assignment.
    order = sorted(syms, key=lambda s: (int(lengths[s]), int(s)))
    for s in order:
        writer.write(int(s), bits)
    if nsym == 4:
        ls = sorted(int(lengths[s]) for s in syms)
        writer.write(1 if ls == [1, 2, 3, 3] else 0, 1)


def _rle_encode_lengths(lengths: np.ndarray):
    """Produce (symbol, extra, n_extra) tokens with RLE 16/17 (RFC 3.5).

    Consecutive 16 (resp. 17) tokens CHAIN: the decoder computes
    new_total = ((old_total - 2) << nbits) + 3 + extra and extends by the
    difference, so a run of R is emitted digit-by-digit (base 4 for 16s,
    base 8 for 17s), mirroring the scheme in RFC 3.5.
    """
    tokens = []
    n = len(lengths)
    prev_nonzero = 8

    def emit_zero_run(reps):
        if reps < 3:
            tokens.extend([(0, 0, 0)] * reps)
            return
        reps -= 3
        chain = []
        while True:
            chain.append((17, reps & 7, 3))
            reps >>= 3
            if reps == 0:
                break
            reps -= 1
        tokens.extend(reversed(chain))  # digits are generated last-first

    def emit_value_run(v, reps, new_value):
        if new_value:
            tokens.append((v, 0, 0))
            reps -= 1
        if reps < 3:
            tokens.extend([(v, 0, 0)] * reps)
            return
        reps -= 3
        chain = []
        while True:
            chain.append((16, reps & 3, 2))
            reps >>= 2
            if reps == 0:
                break
            reps -= 1
        tokens.extend(reversed(chain))

    i = 0
    while i < n:
        v = int(lengths[i])
        j = i
        while j < n and int(lengths[j]) == v:
            j += 1
        run = j - i
        if v == 0:
            if j == n:
                break  # trailing zeros are implicit
            emit_zero_run(run)
        else:
            emit_value_run(v, run, v != prev_nonzero)
            prev_nonzero = v
        i = j
    return tokens


def encoding_table(lengths: np.ndarray):
    """(codes, emit_lengths) for serializing symbols with this code.

    A single-symbol code is emitted with zero bits per symbol (the wire
    marker length 1 is only used to describe the code itself).
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    nz = np.nonzero(lengths)[0]
    if len(nz) == 1:
        return np.zeros_like(lengths), np.zeros_like(lengths)
    return lengths_to_codes(lengths), lengths


def _write_complex(writer, lengths: np.ndarray):
    tokens = _rle_encode_lengths(lengths)
    hist = np.zeros(18, dtype=np.int64)
    for sym, _, _ in tokens:
        hist[sym] += 1
    cl_lengths = build_huffman_lengths(hist, max_bits=5)
    # The decoder requires the code-length code itself to be Kraft-complete;
    # with a single used symbol, pair it with a dummy 1-bit partner.
    nz = np.nonzero(cl_lengths)[0]
    if len(nz) == 1:
        s = int(nz[0])
        cl_lengths[s] = 1
        cl_lengths[0 if s != 0 else 1] = 1
    cl_codes = lengths_to_codes(cl_lengths)

    # Choose HSKIP in {0,2,3}: leading entries of the order known zero.
    order = [int(x) for x in CODE_LENGTH_CODE_ORDER]
    hskip = 0
    while hskip < 3 and cl_lengths[order[hskip]] == 0:
        hskip += 1
    if hskip == 1:
        hskip = 0  # HSKIP==1 on the wire means "simple code"
    writer.write(hskip, 2)

    # Emit code-length-code lengths exactly until the decoder stops reading.
    space = 0
    for k in range(hskip, 18):
        l = int(cl_lengths[order[k]])
        writer.write(int(CLCODE_BITS[l]), int(CLCODE_NBITS[l]))
        if l:
            space += 32 >> l
            if space >= 32:
                break

    for sym, extra, n_extra in tokens:
        writer.write(int(cl_codes[sym]), int(cl_lengths[sym]))
        if n_extra:
            writer.write(int(extra), int(n_extra))
