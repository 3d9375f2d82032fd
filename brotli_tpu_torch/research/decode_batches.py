"""The batch-decode tier's batches that chip_smoke.py and decode_ab.py
decode, made from the seeded corpus (corpus.py).

  serving_batch      1024 streams of 64 KiB at staggered offsets of the
                     corpus's first 24 MiB (repo text, prose, records),
                     even ones through compress_fast q1, odd ones
                     through the native encoder at q3: one device round
  multi_round_batch  8 streams of 8 MiB through compress_fast: two
                     4 MiB metablocks each, two device rounds
  lanes_of           the first round's device lanes of a batch

native_encoder binds BrotliEncoderCompress of the port's native runtime
(native/capi.cpp).
"""

from __future__ import annotations

import ctypes

DECODE_SPAN = 24 << 20      # the corpus's repo text, prose and records
SERVE_STREAMS, SERVE_BYTES = 1024, 1 << 16
MULTI_STREAMS, MULTI_BYTES = 8, 8 << 20


def native_encoder():
    """BrotliEncoderCompress of the port's native runtime as
    enc(data, quality) -> bytes (lgwin 22)."""
    from .. import native_bridge as nb
    lib = ctypes.CDLL(nb.build())
    fn = lib.BrotliEncoderCompress
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
                   ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
                   ctypes.c_char_p]

    def enc(data: bytes, quality: int) -> bytes:
        cap = len(data) + (len(data) >> 2) + 1024
        out = ctypes.create_string_buffer(cap)
        size = ctypes.c_size_t(cap)
        if fn(quality, 22, 0, len(data), data, ctypes.byref(size), out) != 1:
            raise AssertionError(f"BrotliEncoderCompress q{quality} failed")
        return out.raw[:size.value]
    return enc


def _slices(corpus: bytes, count: int, size: int, span: int) -> list:
    stride = (span - size) // (count - 1)
    return [corpus[k * stride:k * stride + size] for k in range(count)]


def serving_batch(corpus: bytes, enc, dev, first: int = SERVE_STREAMS):
    """(streams, inputs) of the serving batch, or of its first `first`
    streams."""
    from .. import compress_fast
    inputs = _slices(corpus, SERVE_STREAMS, SERVE_BYTES, DECODE_SPAN)[:first]
    streams = [compress_fast(p, lgwin=22, quality=1, device=dev)
               if k % 2 == 0 else enc(p, 3) for k, p in enumerate(inputs)]
    return streams, inputs


def multi_round_batch(corpus: bytes, dev):
    """(streams, inputs) of the multi-round batch."""
    from .. import compress_fast
    inputs = _slices(corpus, MULTI_STREAMS, MULTI_BYTES, DECODE_SPAN)
    return [compress_fast(p, lgwin=22, quality=1, device=dev)
            for p in inputs], inputs


def lanes_of(streams) -> list:
    """The device lanes of the first round of `streams` (each must be
    device-eligible)."""
    from ..decode import batch_gpu as B
    lanes = []
    for s in streams:
        plan, _ = B._try_parse_stream(s)
        if plan is None:
            raise AssertionError("a stream meant for the device is not "
                                 "eligible")
        lanes += [seg for kind, seg in plan if kind == "lane"]
    return lanes
