"""File-object wrappers around the streaming compressor and decoder.

The port's copy of brotli_tpu/io_wrappers.py, the reference's streaming
IO: CompressorReader (src/enc/reader.rs), CompressorWriter
(src/enc/writer.rs), and the re-exported Decompressor and
DecompressorWriter (src/lib.rs:38-43).  Host code, no tensor.
"""

from __future__ import annotations

import io

from .decode.stream import StreamDecoder
from .encode.streaming import Compressor


class CompressorReader(io.RawIOBase):
    """Read-side compressor: reading from it yields the compressed form
    of the wrapped stream."""

    def __init__(self, raw, **params):
        self._raw = raw
        self._c = Compressor(**params)
        self._buf = bytearray()
        self._eof = False

    def readable(self):
        return True

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) < n):
            chunk = self._raw.read(1 << 16)
            if not chunk:
                self._buf += self._c.finish()
                self._eof = True
                break
            self._buf += self._c.process(chunk)
        if n < 0:
            out = bytes(self._buf)
            self._buf.clear()
        else:
            out = bytes(self._buf[:n])
            del self._buf[:n]
        return out


class CompressorWriter(io.RawIOBase):
    """Write-side compressor: bytes written are compressed into the
    wrapped stream; close() ends the stream."""

    def __init__(self, raw, **params):
        self._raw = raw
        self._c = Compressor(**params)
        self._closed = False

    def writable(self):
        return True

    def write(self, data) -> int:
        out = self._c.process(bytes(data))
        if out:
            self._raw.write(out)
        return len(data)

    def flush(self):
        if not self._closed and not self._c.is_finished():
            out = self._c.flush()
            if out:
                self._raw.write(out)
        if hasattr(self._raw, "flush"):
            self._raw.flush()

    def close(self):
        if self._closed:
            return
        self._closed = True
        if not self._c.is_finished():
            out = self._c.finish()
            if out:
                self._raw.write(out)
        super().close()

    def into_inner(self):
        """End the stream and return the wrapped stream."""
        self.close()
        return self._raw


class Decompressor(io.RawIOBase):
    """Read-side decompressor; bytes after the last metablock are
    ignored."""

    def __init__(self, raw, custom_dictionary: bytes = b"",
                 large_window: bool = False):
        self._raw = raw
        self._d = StreamDecoder(custom_dictionary, large_window)
        self._buf = bytearray()
        self._eof = False

    def readable(self):
        return True

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) < n):
            chunk = self._raw.read(1 << 16)
            if not chunk:
                self._buf += self._d.finish()
                self._eof = True
                break
            self._buf += self._d.decompress(chunk)
            if self._d.finished:
                self._eof = True
        if n < 0:
            out = bytes(self._buf)
            self._buf.clear()
        else:
            out = bytes(self._buf[:n])
            del self._buf[:n]
        return out


class DecompressorWriter(io.RawIOBase):
    """Write-side decompressor: compressed bytes written are decoded
    into the wrapped stream."""

    def __init__(self, raw, custom_dictionary: bytes = b"",
                 large_window: bool = False):
        self._raw = raw
        self._d = StreamDecoder(custom_dictionary, large_window)
        self._closed = False

    def writable(self):
        return True

    def write(self, data) -> int:
        out = self._d.decompress(bytes(data))
        if out:
            self._raw.write(out)
        return len(data)

    def close(self):
        if self._closed:
            return
        self._closed = True
        super().close()

    def into_inner(self):
        """Close and return the wrapped stream."""
        self.close()
        return self._raw
