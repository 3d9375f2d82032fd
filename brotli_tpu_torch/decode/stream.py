"""Resumable streaming decode (BrotliDecompressStream's contract).

The port's copy of brotli_tpu/decode/stream.py, on the host: input is
fed in chunks of any size, output comes back as it is decoded, a call
may stop at any byte of input and resume with the next, and output can
be throttled (max_output, the reference's NeedsMoreOutput).

Memory is bounded: only the LZ77 window of decoded history is kept
(plus output not yet returned), and a compressed metablock suspends
and resumes at command granularity, so feeding a large metablock one
byte at a time costs O(n) command decodes, not a replay from the
block's start per byte.
"""

from __future__ import annotations

from enum import IntEnum

from ..core import constants as C
from ..core.bitio import BitReader, NeedsMoreInput
from ..core.dictionary import get_dictionary
from .decoder import (BrotliDecodeError, Decoder, NeedsMoreOutput,
                      _read_window_bits)


class Result(IntEnum):
    """The reference's BrotliResult (ffi/decompressor.rs)."""
    ResultFailure = 0
    ResultSuccess = 1
    NeedsMoreInput = 2
    NeedsMoreOutput = 3


class WindowBuffer:
    """bytearray-like output that keeps a bounded tail.

    Indexing is absolute: len() is the total of bytes ever written, and
    bytes before the trim point are gone from memory.  The decoder's
    backward copies never reach past the window, so trimming returned
    bytes older than the window is safe.
    """

    __slots__ = ("_buf", "_dropped")

    def __init__(self):
        self._buf = bytearray()
        self._dropped = 0

    def __len__(self):
        return self._dropped + len(self._buf)

    def append(self, b):
        self._buf.append(b)

    def __iadd__(self, data):
        self._buf += data
        return self

    def __getitem__(self, k):
        if isinstance(k, slice):
            start = (k.start or 0) - self._dropped
            stop = len(self._buf) if k.stop is None \
                else k.stop - self._dropped
            if start < 0:
                raise IndexError("window buffer underrun (trimmed)")
            return self._buf[start:stop]
        if k < 0:
            return self._buf[k]
        return self._buf[k - self._dropped]

    def __delitem__(self, k):
        # rollback: del out[abs_pos:]
        assert isinstance(k, slice) and k.stop is None
        start = k.start - self._dropped
        assert start >= 0, "rollback into trimmed history"
        del self._buf[start:]

    def trim(self, keep_from: int):
        """Drop the kept bytes before absolute position keep_from."""
        cut = keep_from - self._dropped
        if cut > 0:
            del self._buf[:cut]
            self._dropped = keep_from


class StreamDecoder:
    """Incremental RFC 7932 decoder with bounded memory."""

    def __init__(self, custom_dictionary: bytes = b"",
                 large_window: bool = False):
        self._dec = Decoder(custom_dictionary, large_window)
        self._reader = BitReader(b"")
        self._out = WindowBuffer()
        self._emitted = 0
        self._dist_cache = list(C.INITIAL_DISTANCE_CACHE)
        self._window_size = None
        self._static_dict = get_dictionary()
        self._pending = None        # (_MetablockState, islast) mid-block
        self._uncomp_left = 0       # uncompressed payload still to come
        self.finished = False
        self.error = None

    @property
    def total_out(self) -> int:
        return len(self._out)

    @property
    def has_more_output(self) -> bool:
        return self._emitted < len(self._out)

    def decompress(self, chunk: bytes, max_output: int | None = None) \
            -> bytes:
        """Feed input; returns up to max_output new bytes (the surplus
        and the suspended state wait for later calls: the
        NeedsMoreOutput contract of BrotliDecompressStream).  An error
        is sticky: every later call raises it again."""
        if self.error:
            raise self.error
        if chunk:
            self._reader.extend(bytes(chunk))
        r = self._reader
        dec = self._dec
        out_limit = None if max_output is None \
            else self._emitted + max_output
        try:
            while not self.finished and (
                    out_limit is None or len(self._out) < out_limit):
                if self._uncomp_left:
                    take = min(self._uncomp_left, r.bytes_available())
                    if take:
                        self._out += r.read_bytes(take)
                        self._uncomp_left -= take
                    if self._uncomp_left:
                        break  # needs more input
                    continue
                if self._pending is not None:
                    st, islast = self._pending
                    try:
                        dec._run_commands(
                            r, self._out, st, self._window_size,
                            self._dist_cache, dec.custom_dictionary,
                            self._static_dict, resumable=True,
                            out_limit=out_limit)
                    except (NeedsMoreInput, NeedsMoreOutput):
                        break
                    self._pending = None
                    if islast:
                        self.finished = True
                    continue
                if not self._next_block_header(r):
                    break
        except (ValueError, BrotliDecodeError) as e:
            self.error = e if isinstance(e, BrotliDecodeError) \
                else BrotliDecodeError(str(e))
            raise self.error from None
        upto = len(self._out) if out_limit is None \
            else min(len(self._out), out_limit)
        new = bytes(self._out[self._emitted:upto])
        self._emitted = upto
        # keep only the window's bytes of returned history
        if self._window_size:
            self._out.trim(max(0, min(
                self._emitted, len(self._out) - self._window_size)))
        return new

    def _next_block_header(self, r) -> bool:
        """Parse the next metablock header; False where the input ran
        out (the reader rolled back to the header's start)."""
        dec = self._dec
        ckpt = r.checkpoint()
        try:
            if self._window_size is None:
                wbits = _read_window_bits(r, dec.large_window)
                self._window_size = (1 << wbits) - 16
                return True
            islast = r.read(1)
            if islast and r.read(1):  # ISLASTEMPTY
                self.finished = True
                return True
            mnibbles = r.read(2)
            if mnibbles == 3:
                if r.read(1):
                    raise BrotliDecodeError("reserved bit set")
                mskip = r.read(2)
                skip = (r.read(8 * mskip) + 1) if mskip else 0
                if r.align_to_byte():
                    raise BrotliDecodeError("nonzero metadata padding")
                r.read_bytes(skip)
                if islast:
                    self.finished = True
                return True
            mlen = r.read(16 + 4 * mnibbles) + 1
            if not islast and r.read(1):  # ISUNCOMPRESSED
                # RFC 7932 section 9.2: the alignment bits must be zero
                if r.align_to_byte() != 0:
                    raise BrotliDecodeError(
                        "nonzero padding before uncompressed block")
                self._uncomp_left = mlen
                return True
            st = dec._parse_metablock_header(r, mlen)
            self._pending = (st, bool(islast))
            return True
        except NeedsMoreInput:
            r.restore(ckpt)
            return False

    def finish(self) -> bytes:
        """Signal the end of input; raises if the stream is incomplete."""
        out = self.decompress(b"")
        if not self.finished:
            raise BrotliDecodeError("truncated brotli stream")
        return out
