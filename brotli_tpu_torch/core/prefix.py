"""Canonical prefix (Huffman) codes: code assignment, reader and writer.

A trimmed copy of brotli_tpu/core/prefix.py (RFC 7932 section 3):
canonical codes (3.2), simple prefix codes (3.4) and complex prefix
codes with the code-length code and RLE repeats (3.5), as the encoder
writes them and as the batch decoder's header walk reads them.
"""

from __future__ import annotations

import numpy as np

from .constants import (CLCODE_BITS, CLCODE_NBITS, CODE_LENGTH_CODE_ORDER,
                        MAX_HUFF_BITS, REPEAT_PREVIOUS_CODE_LENGTH)
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


def check_complete(lengths: np.ndarray) -> bool:
    """Kraft equality check (the format requires complete codes)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    nz = lengths[lengths > 0]
    if len(nz) == 0:
        return False
    if len(nz) == 1:
        return True  # single-symbol code, zero bits
    return int(np.sum(1 << (MAX_HUFF_BITS - nz))) == 1 << MAX_HUFF_BITS


class PrefixDecoder:
    """Peek-based prefix decoder built from code lengths."""

    __slots__ = ("max_len", "sym_table", "len_table", "single")

    def __init__(self, lengths: np.ndarray):
        lengths = np.asarray(lengths, dtype=np.int64)
        nz_syms = np.nonzero(lengths > 0)[0]
        if len(nz_syms) == 0:
            raise ValueError("empty prefix code")
        if len(nz_syms) == 1:
            self.single = int(nz_syms[0])
            self.max_len = 0
            self.sym_table = None
            self.len_table = None
            return
        self.single = -1
        if not check_complete(lengths):
            raise ValueError("incomplete/oversubscribed prefix code")
        top = int(np.max(lengths))
        self.max_len = top
        codes = lengths_to_codes(lengths)
        sym_table = np.zeros(1 << top, dtype=np.int32)
        len_table = np.zeros(1 << top, dtype=np.int8)
        for ln in range(1, top + 1):
            syms = np.nonzero(lengths == ln)[0]
            if len(syms) == 0:
                continue
            reps = np.arange(1 << (top - ln), dtype=np.int64) << ln
            idx = (codes[syms][:, None] + reps[None, :]).ravel()
            sym_table[idx] = np.repeat(syms, 1 << (top - ln))
            len_table[idx] = ln
        self.sym_table = sym_table
        self.len_table = len_table

    def decode(self, reader) -> int:
        if self.single >= 0:
            return self.single
        bits = reader.peek(self.max_len)
        reader.skip(int(self.len_table[bits]))
        return int(self.sym_table[bits])


def _alphabet_bits(alphabet_size: int) -> int:
    return max(1, (alphabet_size - 1).bit_length())


def read_prefix_code(reader, alphabet_size: int) -> np.ndarray:
    """Read a prefix-code description; returns per-symbol code lengths
    (a one-symbol simple code gets the marker length 1)."""
    lengths = np.zeros(alphabet_size, dtype=np.int64)
    hskip = reader.read(2)
    if hskip == 1:
        # simple code with 1..4 symbols
        nsym = reader.read(2) + 1
        bits = _alphabet_bits(alphabet_size)
        syms = []
        for _ in range(nsym):
            s = reader.read(bits)
            if s >= alphabet_size or s in syms:
                raise ValueError("invalid simple prefix code symbol")
            syms.append(s)
        if nsym == 1:
            lengths[syms[0]] = 1
        elif nsym == 2:
            lengths[syms[0]] = lengths[syms[1]] = 1
        elif nsym == 3:
            lengths[syms[0]] = 1
            lengths[syms[1]] = lengths[syms[2]] = 2
        elif reader.read(1):
            lengths[syms[0]] = 1
            lengths[syms[1]] = 2
            lengths[syms[2]] = lengths[syms[3]] = 3
        else:
            lengths[syms] = 2
        return lengths

    # complex code: the code-length code's lengths first
    cl_lengths = np.zeros(18, dtype=np.int64)
    space = 0
    num_codes = 0
    for i in range(hskip, 18):
        ln = _read_clcode_length(reader)
        cl_lengths[int(CODE_LENGTH_CODE_ORDER[i])] = ln
        if ln:
            num_codes += 1
            space += 32 >> ln
            if space >= 32:
                break
    if num_codes != 1 and space != 32:  # one code-length code is allowed
        raise ValueError("corrupt code-length code")
    cl_decoder = PrefixDecoder(cl_lengths)

    # symbol code lengths with RLE repeats
    space = 0
    prev_nonzero = 8
    i = 0
    prev_repeat_sym = -1
    repeat = 0
    while i < alphabet_size and space < 32768:
        sym = cl_decoder.decode(reader)
        if sym < 16:
            lengths[i] = sym
            i += 1
            prev_repeat_sym = -1
            if sym:
                prev_nonzero = sym
                space += 32768 >> sym
            continue
        extra_bits = 2 if sym == REPEAT_PREVIOUS_CODE_LENGTH else 3
        extra = reader.read(extra_bits)
        if prev_repeat_sym == sym:
            new_repeat = ((repeat - 2) << extra_bits) + 3 + extra
            delta = new_repeat - repeat
        else:
            new_repeat = 3 + extra
            delta = new_repeat
        repeat = new_repeat
        prev_repeat_sym = sym
        val = prev_nonzero if sym == REPEAT_PREVIOUS_CODE_LENGTH else 0
        if i + delta > alphabet_size:
            raise ValueError("repeat overruns alphabet")
        lengths[i:i + delta] = val
        i += delta
        if val:
            space += delta * (32768 >> val)
    if space > 32768:
        raise ValueError("oversubscribed prefix code")
    if space != 32768:
        raise ValueError("incomplete prefix code")
    return lengths


def _read_clcode_length(reader) -> int:
    """Decode one symbol of the fixed code-length-code code (RFC 3.5):
    00 -> 0, 01 -> 3, 10 -> 4, 110 -> 2, 1110 -> 1, 1111 -> 5 (bits in
    reading order)."""
    if reader.read(1) == 0:
        return 0 if reader.read(1) == 0 else 3
    if reader.read(1) == 0:
        return 4
    if reader.read(1) == 0:
        return 2
    return 1 if reader.read(1) == 0 else 5


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
