"""The plain reference that decides `correct`.

Brotli is lossless: a compressed stream has to decode to exactly the
bytes it was made from, and a decoder has to give exactly the bytes a
stream was made from.  The reference for a compress cell is google/
brotli's own decoder (libbrotlidec, RFC 7932's reference
implementation, from the machine's system libraries): every stream the
window produced is decoded by it and compared with its input.  For a
decode cell the reference is the plaintext the benchmark generated.

This module imports nothing of the program, of the JAX package or of
JAX: only the standard library.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_LIB = []


def _decoder():
    """libbrotlidec's BrotliDecoderDecompress; raises where the machine
    has no libbrotlidec (the run then has no reference and fails)."""
    if not _LIB:
        name = ctypes.util.find_library("brotlidec")
        if name is None:
            raise RuntimeError("reference: libbrotlidec not found; no "
                               "reference decoder for compress cells")
        lib = ctypes.CDLL(name)
        fn = lib.BrotliDecoderDecompress
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_size_t, ctypes.c_char_p,
                       ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
        _LIB.append(fn)
    return _LIB[0]


def decode(stream: bytes, size: int):
    """The bytes libbrotlidec decodes from `stream`, reading at most
    size + 1 bytes of output, or None where it rejects the stream."""
    fn = _decoder()
    out = ctypes.create_string_buffer(size + 1)
    osz = ctypes.c_size_t(size + 1)
    if fn(len(stream), bytes(stream), ctypes.byref(osz), out) != 1:
        return None
    return out.raw[:osz.value]


def bad_streams(pairs) -> int:
    """How many (stream, plaintext) pairs do not round-trip: the stream
    is rejected, or decodes to other bytes than its plaintext."""
    bad = 0
    for stream, plain in pairs:
        if not isinstance(stream, (bytes, bytearray)) \
                or decode(stream, len(plain)) != plain:
            bad += 1
    return bad


def bad_outputs(pairs) -> int:
    """How many (output, plaintext) pairs differ."""
    return sum(1 for out, plain in pairs
               if not isinstance(out, (bytes, bytearray))
               or bytes(out) != plain)
