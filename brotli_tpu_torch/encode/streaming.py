"""The streaming compressor: chunked encode with bounded memory and the
window's context carried across chunks.

The port's copy of brotli_tpu/encode/streaming.py, on the host, byte
for byte the same streams.  Each processed chunk becomes one metablock;
the last `window` bytes of input already processed ride along as match
context (distances reach back across chunk boundaries, as through the
reference's ring buffer), and the distance cache and the partial output
byte carry across metablocks.

The operations are the reference's (BrotliEncoderCompressStream):
process() buffers input and emits whole chunks (OPERATION_PROCESS),
flush() forces pending input out and byte-aligns with a padding
metablock (OPERATION_FLUSH), emit_metadata() writes a skippable
metadata metablock (OPERATION_EMIT_METADATA), finish() ends the stream
(OPERATION_FINISH).

Routes by quality: below 10 one native parse session spans the chunks
(its buffer compacts back to the window about every 8 chunks); at 10
and above the optimal parser runs once a chunk against the carried
context.  Where native_bridge.available() is false, there is no
session: below 10 the match finder and the greedy walk (their numpy
and Python forms) run once a chunk over the carried context and the
chunk, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from .. import native_bridge as nb
from ..core import constants as C
from ..core.bitio import BitWriter
from . import bitstream as bs
from .command import resolve_commands
from .encoder import POISONED_DISTANCE, _quality_knobs
from .match import find_best_matches, greedy_parse
from .params import EncoderParams
from .zopfli import zopfli_segment


class Compressor:
    """Incremental encoder with bounded memory.  A compressor below
    quality 10 holds a native parse session (one of a bounded pool)
    until finish() or until it is garbage-collected."""

    def __init__(self, quality: int = 9, lgwin: int = 22, mode: int = 0,
                 chunk_size: int | None = None, lgblock: int = 0,
                 custom_dictionary: bytes = b"", catable: bool = False,
                 appendable: bool = False, byte_align: bool = False,
                 magic_number: bool = False, stream_offset: int = 0):
        self.params = EncoderParams(
            quality=quality, lgwin=lgwin, mode=mode, lgblock=lgblock,
            catable=catable, appendable=appendable, byte_align=byte_align,
            magic_number=magic_number,
            stream_offset=stream_offset).sanitize(None)
        if chunk_size is None:
            chunk_size = min(1 << self.params.lgblock, 1 << 20)
        # one metablock a chunk: RFC 7932 bounds MLEN at 1 << 24
        self.chunk_size = max(1, min(chunk_size, 1 << 24))
        self._w = BitWriter()
        self._pending = bytearray()
        self._context = np.frombuffer(
            bytes(custom_dictionary)[-self.params.window_size:],
            dtype=np.uint8)
        # BROTLI_PARAM_STREAM_OFFSET: positions (and so which short codes
        # and dictionary distances are legal) start at the stream's byte
        # offset in the larger concatenated output
        self._abs_pos = len(self._context) + self.params.stream_offset
        self._cache = list(C.INITIAL_DISTANCE_CACHE)
        self._started = False
        self._finished = False
        self._head_written = False
        self._out_emitted = 0
        # the persistent native parse session (below quality 10) and
        # its buffer [retained window | appended chunks]
        self._sess = None
        self._nbuf = None
        self._nlen = 0
        self._sdlen = 0

    def _start(self):
        if self._started:
            return
        self._started = True
        p = self.params
        if not (p.bare and p.catable):
            bs.write_stream_header(self._w, p.lgwin, p.large_window)
        if p.magic_number:
            bs.write_magic_number(self._w, 0, catable=p.catable,
                                  appendable=p.appendable)
        if p.catable:
            self._cache = [POISONED_DISTANCE] * 4
            # the 2-byte raw head goes out with the first data chunk

    def _emit_chunk(self, chunk: np.ndarray, is_last: bool):
        p = self.params
        self._start()
        if p.catable and not self._head_written and len(chunk) > 0:
            self._head_written = True
            k = min(2, len(chunk))
            bs.store_uncompressed_meta_block(self._w, chunk[:k].tobytes())
            self._advance(chunk[:k])
            chunk = chunk[k:]
            if len(chunk) == 0:
                if is_last:
                    self._end_stream()
                return
        n = len(chunk)
        if n == 0:
            if is_last:
                self._end_stream()
            return
        use_session = p.quality < 10 and nb.available()
        if use_session:
            full, dlen = self._append_to_session(chunk, p)
            start = self._nlen - n
        else:
            full = np.concatenate([self._context, chunk])
            dlen = len(self._context)
            start = dlen
        if p.quality >= 10:
            # the one-shot quality tier, the optimal parse of the chunk
            # against the carried context (as the reference's
            # WriteMetaBlockInternal runs q10/11 when streaming)
            seg = zopfli_segment(full, p, dict_len=dlen,
                                 initial_cache=tuple(self._cache),
                                 iters=1 if p.q9_5 else None)
        elif use_session:
            seg = self._sess.next(self._nlen - self._sdlen)
        else:
            bl, bd, bsc, isd, bw = find_best_matches(
                full, p.window_size, dict_len=dlen,
                literal_byte_score=p.literal_byte_score,
                use_dictionary=not p.catable, **_quality_knobs(p))
            seg = greedy_parse(full, bl, bd, bsc, [n], dlen, 0,
                               tuple(self._cache), isd, p.window_size,
                               bw)[0]
        ins, cps, dst, adv = seg
        cmds, new_cache = resolve_commands(
            ins, cps, dst, p.dist, advance=adv, initial_cache=self._cache,
            pos_offset=self._abs_pos, window_size=p.window_size)
        suppress = p.appendable or p.byte_align
        # kept within 8 * n + 40 bits, else stored uncompressed (with
        # the empty last metablock after it where it ends the stream)
        if bs.store_meta_block_or_raw(self._w, full, start, n, cmds, p.dist,
                                      p.quality, n, p.mode,
                                      is_last and not suppress):
            self._cache = new_cache
        self._advance(chunk)
        if is_last and suppress:
            self._trailer()

    def _append_to_session(self, chunk: np.ndarray, p):
        """Append a chunk to the persistent parse buffer and session;
        returns (full, dict_len).  When the buffer fills it compacts
        back to the window and the session starts anew (the only points
        that pay for re-priming the hash tables)."""
        n = len(chunk)
        if self._sess is not None and self._nlen + n > len(self._nbuf):
            w = p.window_size
            self._context = self._nbuf[max(0, self._nlen - w):
                                       self._nlen].copy()
            self._sess.close()
            self._sess = None
        if self._sess is None:
            ctx = np.asarray(self._context, dtype=np.uint8)
            dlen = len(ctx)
            cap = dlen + n + max(p.window_size, 8 * self.chunk_size)
            self._nbuf = np.zeros(cap, dtype=np.uint8)
            self._nbuf[:dlen] = ctx
            self._nbuf[dlen:dlen + n] = chunk
            self._nlen = dlen + n
            self._sdlen = dlen
            self._sess = nb.ParseSession(
                self._nbuf[:self._nlen], p.window_size, dict_len=dlen,
                pos0=0, initial_cache=tuple(self._cache),
                literal_byte_score=p.literal_byte_score,
                use_dictionary=not p.catable, **_quality_knobs(p))
        else:
            self._nbuf[self._nlen:self._nlen + n] = chunk
            self._nlen += n
            self._sess.extend(self._nbuf[:self._nlen])
        return self._nbuf[:self._nlen], self._sdlen

    def _advance(self, chunk: np.ndarray):
        self._abs_pos += len(chunk)
        if self._sess is not None:
            # the session's buffer is the retained window; _context is
            # cut from it at compaction
            return
        w = self.params.window_size
        self._context = np.concatenate([self._context, chunk])[-w:]

    def _end_stream(self):
        """End the stream after an empty final chunk, or after content
        blocks whose ISLAST was suppressed."""
        p = self.params
        if p.appendable or p.byte_align:
            self._trailer()
        else:
            bs.write_empty_last_meta_block(self._w)

    def _trailer(self):
        p = self.params
        if p.byte_align:
            bs.write_padding_meta_block(self._w)
        if (p.appendable or p.byte_align) and not p.bare:
            bs.write_empty_last_meta_block(self._w)

    def _take_pending(self):
        """Emit the buffered input as one chunk, or start the stream."""
        if self._pending:
            chunk = np.frombuffer(bytes(self._pending), np.uint8)
            self._pending.clear()
            self._emit_chunk(chunk, False)
        else:
            self._start()

    def _check_open(self):
        if self._finished:
            raise RuntimeError("compressor already finished")

    # -- public API ------------------------------------------------------
    def process(self, data: bytes) -> bytes:
        """Buffer input; emit output as whole chunks complete
        (OPERATION_PROCESS)."""
        self._check_open()
        self._pending += bytes(data)
        while len(self._pending) >= self.chunk_size:
            chunk = np.frombuffer(
                bytes(self._pending[:self.chunk_size]), np.uint8)
            del self._pending[:self.chunk_size]
            self._emit_chunk(chunk, False)
        return self._drain()

    def flush(self) -> bytes:
        """Emit all pending input and byte-align (OPERATION_FLUSH)."""
        self._check_open()
        self._take_pending()
        bs.write_padding_meta_block(self._w)
        return self._drain()

    def emit_metadata(self, payload: bytes) -> bytes:
        """Write a skippable metadata metablock
        (OPERATION_EMIT_METADATA; the reference's process_metadata)."""
        self._check_open()
        self._take_pending()
        bs.write_metadata_meta_block(self._w, payload)
        return self._drain()

    def finish(self) -> bytes:
        """End the stream (OPERATION_FINISH) and release the parse
        session."""
        self._check_open()
        self._finished = True
        chunk = np.frombuffer(bytes(self._pending), np.uint8)
        self._pending.clear()
        self._start()
        if len(chunk):
            self._emit_chunk(chunk, True)
        else:
            self._end_stream()
        if self._sess is not None:
            self._sess.close()
            self._sess = None
            self._nbuf = None
        return self._drain()

    def is_finished(self) -> bool:
        return self._finished

    def _drain(self) -> bytes:
        buf = self._w.buf
        # hold back the last (maybe partial) byte until finished
        upto = len(buf) if self._finished else max(
            0, len(buf) - (0 if self._w.is_byte_aligned() else 1))
        out = bytes(buf[self._out_emitted:upto])
        self._out_emitted = upto
        return out
