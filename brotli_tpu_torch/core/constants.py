"""RFC 7932 format constants used by the port's encoders and decoders.

A trimmed copy of brotli_tpu/core/constants.py: the distance cache
seed, the literal context modes and their lookup tables (loaded from
this package's data/context_lut.npy), the window-bits header code, the
dictionary word bounds, what the trivial metablock store reads -- the
insert/copy length codes, the command cells and the code-length code
tables -- and what the decoders read: the block length codes, the
distance short codes, distance symbols and their extra bits, and the
distance alphabet size.  The optimal parser prices commands through
combine_length_codes and distances through encode_distance.
"""

from __future__ import annotations

import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")

NUM_DISTANCE_SHORT_CODES = 16

MIN_WINDOW_BITS = 10
LARGE_MAX_WINDOW_BITS = 30

MIN_DICTIONARY_WORD_LENGTH = 4
MAX_DICTIONARY_WORD_LENGTH = 24
NUM_TRANSFORMS = 121

MAX_HUFF_BITS = 15  # max depth of any prefix code in the format
NUM_BLOCK_LEN_SYMBOLS = 26

# Insert / copy length codes (RFC 7932 section 5)
INSERT_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5,
     6, 7, 8, 9, 10, 12, 14, 24], dtype=np.int64)
INSERT_BASE = np.zeros(24, dtype=np.int64)
INSERT_BASE[1:] = np.cumsum(1 << INSERT_EXTRA)[:-1]

COPY_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4,
     5, 5, 6, 7, 8, 9, 10, 24], dtype=np.int64)
COPY_BASE = np.full(24, 2, dtype=np.int64)
COPY_BASE[1:] += np.cumsum(1 << COPY_EXTRA)[:-1]


# Block length codes (RFC 7932 section 6)
BLOCK_LEN_EXTRA = np.array(
    [2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5,
     6, 6, 7, 8, 9, 10, 11, 12, 13, 24], dtype=np.int64)
BLOCK_LEN_BASE = np.ones(26, dtype=np.int64)
BLOCK_LEN_BASE[1:] += np.cumsum(1 << BLOCK_LEN_EXTRA)[:-1]


def get_insert_length_code(insert_len):
    """Vectorized insert-length -> code (0..23)."""
    il = np.asarray(insert_len, dtype=np.int64)
    return (np.searchsorted(INSERT_BASE, il, side="right") - 1).astype(
        np.int64)


def get_copy_length_code(copy_len):
    cl = np.asarray(copy_len, dtype=np.int64)
    return (np.searchsorted(COPY_BASE, cl, side="right") - 1).astype(
        np.int64)


def get_block_length_code(block_len):
    bl = np.asarray(block_len, dtype=np.int64)
    return (np.searchsorted(BLOCK_LEN_BASE, bl, side="right") - 1).astype(
        np.int64)


# The 704 command symbols are 11 cells of 64 (RFC 7932 section 5):
# within a cell the low 3 bits select the copy code and bits 3-5 the
# insert code; cells 0 and 1 imply distance code 0 and carry no
# distance symbol.
_CELLS = [  # (insert_code_base, copy_code_base, implicit_distance_zero)
    (0, 0, True), (0, 8, True),
    (0, 0, False), (0, 8, False),
    (8, 0, False), (8, 8, False),
    (0, 16, False), (16, 0, False),
    (8, 16, False), (16, 8, False),
    (16, 16, False),
]

CMD_TO_INSERT_CODE = np.zeros(704, dtype=np.int64)
CMD_TO_COPY_CODE = np.zeros(704, dtype=np.int64)
CMD_IMPLICIT_DIST0 = np.zeros(704, dtype=bool)
for _cell, (_ib, _cb, _imp) in enumerate(_CELLS):
    _idx = np.arange(64) + 64 * _cell
    CMD_TO_INSERT_CODE[_idx] = _ib + ((np.arange(64) >> 3) & 7)
    CMD_TO_COPY_CODE[_idx] = _cb + (np.arange(64) & 7)
    CMD_IMPLICIT_DIST0[_idx] = _imp

def combine_length_codes(ins_code, copy_code, use_last_distance):
    """(insert code, copy code, distance code 0?) -> command symbol,
    vectorized; the inverse of the CMD_TO_* tables."""
    ins_code = np.asarray(ins_code, dtype=np.int64)
    copy_code = np.asarray(copy_code, dtype=np.int64)
    use_last = np.asarray(use_last_distance, dtype=bool)
    bits64 = (copy_code & 7) | ((ins_code & 7) << 3)
    short = use_last & (ins_code < 8) & (copy_code < 16)
    short_code = bits64 + np.where(copy_code < 8, 0, 64)
    sub = 2 * ((copy_code >> 3) + 3 * (ins_code >> 3))
    offset = (sub << 5) + 0x40 + ((0x520D40 >> sub) & 0xC0)
    return np.where(short, short_code, offset | bits64)


# Distance short codes 0..15 as (cache index, delta) (RFC 7932 section 4)
DISTANCE_SHORT_CODE_INDEX = np.array(
    [0, 1, 2, 3, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1], dtype=np.int64)
DISTANCE_SHORT_CODE_DELTA = np.array(
    [0, 0, 0, 0, -1, 1, -2, 2, -3, 3, -1, 1, -2, 2, -3, 3], dtype=np.int64)


def distance_alphabet_size(npostfix: int, ndirect: int,
                           max_distbits: int = 24):
    """Number of distance symbols for NPOSTFIX/NDIRECT (24 distance
    bits for a regular stream)."""
    return NUM_DISTANCE_SHORT_CODES + ndirect + (max_distbits
                                                 << (npostfix + 1))

def decode_distance(dcode, npostfix, ndirect, extra):
    """Distance symbol (>= 16 + ndirect) and its extra bits ->
    distance."""
    h = dcode - ndirect - NUM_DISTANCE_SHORT_CODES
    hcode = h >> npostfix
    lcode = h & ((1 << npostfix) - 1)
    ndistbits = 1 + (hcode >> 1)
    offset = ((2 + (hcode & 1)) << ndistbits) - 4
    return ((offset + extra) << npostfix) + lcode + ndirect + 1


def num_distance_extra_bits(dcode, npostfix, ndirect):
    h = np.asarray(dcode, dtype=np.int64) - ndirect - NUM_DISTANCE_SHORT_CODES
    return 1 + ((h >> npostfix) >> 1)


def encode_distance(distance, npostfix, ndirect):
    """Distance (> ndirect, no short code) -> (symbol, extra, extra
    bits), vectorized; the inverse of decode_distance.  The two hcode
    buckets of ndistbits = n cover dp in [2^(n+1) - 4, 2^(n+2) - 4), so
    n = floor(log2(dp + 4)) - 1."""
    d = np.asarray(distance, dtype=np.int64) - ndirect - 1
    lcode = d & ((1 << npostfix) - 1)
    dp = d >> npostfix
    n = (np.int64(np.log2(dp + 4 + 1e-9))
         if np.ndim(dp) == 0 else np.log2(dp + 4 + 1e-9).astype(np.int64)) - 1
    prefix = ((dp + 4) >> n) & 1
    extra = dp + 4 - ((2 + prefix) << n)
    hcode = 2 * (n - 1) + prefix
    sym = NUM_DISTANCE_SHORT_CODES + ndirect + ((hcode << npostfix) | lcode)
    return sym, extra, n


def distance_context_from_copy_len(copy_len):
    """2-bit distance context (RFC 7932 section 7.2): min(copy_len, 5)
    - 2, clamped at 0."""
    cl = np.asarray(copy_len, dtype=np.int64)
    return np.clip(cl, 2, 5) - 2


# Code-length code (RFC 7932 section 3.5): the order its lengths are
# sent in, and the fixed code of those lengths (LSB-first bits, nbits)
CODE_LENGTH_CODE_ORDER = np.array(
    [1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    dtype=np.int64)
CLCODE_BITS = np.array([0b00, 0b0111, 0b011, 0b10, 0b01, 0b1111, 0, 0],
                       dtype=np.int64)
CLCODE_NBITS = np.array([2, 4, 3, 2, 2, 4, 0, 0], dtype=np.int64)
REPEAT_PREVIOUS_CODE_LENGTH = 16  # 2 extra bits
REPEAT_ZERO_CODE_LENGTH = 17      # 3 extra bits

# Most-recent-first: "last distance" starts as 4 (RFC 7932 section 4).
INITIAL_DISTANCE_CACHE = (4, 11, 15, 16)

# Context modes (RFC 7932 section 7.1)
CONTEXT_LSB6 = 0
CONTEXT_MSB6 = 1
CONTEXT_UTF8 = 2
CONTEXT_SIGNED = 3

_LUT = np.load(os.path.join(_DATA_DIR, "context_lut.npy"))
# CONTEXT_LUT0[mode][p1] | CONTEXT_LUT1[mode][p2]
CONTEXT_LUT0 = np.stack([_LUT[512 * m:512 * m + 256] for m in range(4)])
CONTEXT_LUT1 = np.stack([_LUT[512 * m + 256:512 * (m + 1)] for m in range(4)])


def encode_window_bits(lgwin: int, large_window: bool = False):
    """Return (bits, nbits) for the stream header WBITS field
    (RFC 7932 section 9.1)."""
    if large_window:
        if not (10 <= lgwin <= LARGE_MAX_WINDOW_BITS):
            raise ValueError(f"large-window lgwin out of range: {lgwin}")
        return ((lgwin & 0x3F) << 8) | 0x11, 14
    if lgwin == 16:
        return 0, 1
    if lgwin == 17:
        return 1, 7
    if 17 < lgwin <= 24:
        return ((lgwin - 17) << 1) | 1, 4
    if 10 <= lgwin < 16:
        return ((lgwin - 8) << 4) | 1, 7
    raise ValueError(f"lgwin out of range: {lgwin}")
