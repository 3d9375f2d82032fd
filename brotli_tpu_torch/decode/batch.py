"""Batched decompression on the host: independent streams decoded side
by side.

The port's copy of brotli_tpu/decode/batch.py.  A stream decodes
serially, so throughput comes from many streams at once: the native
decoder releases the GIL during its call, so a thread pool scales, each
worker thread with its own table arena and output buffer.  Where the
native runtime does not build, the pure-Python Decoder decodes each
stream.  The device tier is decompress_batch_gpu (batch_gpu.py).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native_bridge as nb
from ..core.bitio import NeedsMoreInput
from .decoder import BrotliDecodeError, Decoder

_tls = threading.local()


def _decode_one(stream: bytes, custom_dictionary: bytes,
                large_window: bool, size_hint) -> bytes:
    if not nb.available():
        return Decoder(custom_dictionary, large_window).decompress(stream)
    lib = nb.get_lib()
    if not hasattr(_tls, "table_mem"):
        _tls.table_mem = np.zeros(1 << 23, dtype=np.int32)
    src = np.frombuffer(bytes(stream), dtype=np.uint8)
    cd = np.frombuffer(bytes(custom_dictionary), dtype=np.uint8)
    cap = max(size_hint or 0, 4 * len(src) + (1 << 16))
    while True:
        # the thread's output buffer, kept across calls: a fresh buffer
        # above the malloc mmap threshold faults in every page
        out = getattr(_tls, "out_buf", None)
        if out is None or len(out) < cap:
            out = _tls.out_buf = np.empty(cap, dtype=np.uint8)
        r = lib.decode_native(
            nb._ptr(src, nb.U8P), len(src), nb._ptr(out, nb.U8P), cap,
            nb._ptr(cd, nb.U8P) if len(cd) else nb.U8P(), len(cd),
            int(large_window), nb._ptr(_tls.table_mem, nb.I32P),
            len(_tls.table_mem))
        if r == -3:  # output buffer too small
            if cap >= 1 << 31:
                raise BrotliDecodeError("output too large")
            cap *= 8
            continue
        if r == -1:
            raise NeedsMoreInput()
        if r < 0:
            raise BrotliDecodeError(f"corrupt stream (code {r})")
        return out[:r].tobytes()


def decompress_batch(streams, custom_dictionary: bytes = b"",
                     large_window: bool = False, threads: int = 8,
                     size_hints=None):
    """Decode a list of independent streams concurrently; returns their
    outputs in input order.  Every worker is joined before the first
    error is raised (the reference's join-all rule)."""
    streams = list(streams)
    hints = size_hints or [None] * len(streams)
    if threads <= 1 or len(streams) <= 1:
        return [_decode_one(s, custom_dictionary, large_window, h)
                for s, h in zip(streams, hints)]
    results = [None] * len(streams)
    first_err = None
    with ThreadPoolExecutor(max_workers=threads) as pool:
        futs = {pool.submit(_decode_one, s, custom_dictionary,
                            large_window, h): i
                for i, (s, h) in enumerate(zip(streams, hints))}
        for f, i in futs.items():
            try:
                results[i] = f.result()
            except Exception as e:  # noqa: BLE001 -- re-raised below
                if first_err is None:
                    first_err = e
    if first_err is not None:
        raise first_err
    return results
