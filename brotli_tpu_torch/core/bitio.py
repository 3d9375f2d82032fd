"""LSB-first bit reader and writer for the RFC 7932 stream (host side).

A copy of brotli_tpu/core/bitio.py.  BitReader: bits, peeks, byte
alignment and whole bytes at absolute bit positions, and for the
streaming decoder the appended input (extend, which drops consumed
bytes beyond a rollback slack), checkpoints and the counts of bits
consumed and available.  BitWriter: headers, whole-byte stores, the
append of natively packed metablocks (at any bit position, or
assembled at the writer's own bit phase), and the checkpoint that
rolls a metablock back for the uncompressed fallback.
"""

from __future__ import annotations

import numpy as np


class NeedsMoreInput(Exception):
    """Raised by BitReader when the buffer is exhausted mid-read."""


class BitReader:
    """LSB-first bit reader over a byte buffer.

    Positions are absolute: `bit_pos` is the position of the next bit
    in the whole stream, and `base` counts the bits of consumed input
    that extend() has dropped from memory (the streaming decoder keeps
    a slack of recent history for its command-granular rollback, so
    the buffer stays bounded)."""

    __slots__ = ("data", "bit_pos", "bit_len", "base")

    # consumed history kept for rollback (a command or metablock header
    # never spans more than ~42 KB of input)
    _SLACK_BYTES = 256 << 10

    def __init__(self, data):
        self.data = np.frombuffer(bytes(data), dtype=np.uint8)
        self.bit_pos = 0
        self.bit_len = len(self.data) * 8
        self.base = 0

    def extend(self, more: bytes):
        """Append more input (streaming decode); drops the consumed
        bytes beyond the rollback slack."""
        drop_bytes = ((self.bit_pos - self.base) >> 3) - self._SLACK_BYTES
        if drop_bytes > 0:
            self.data = self.data[drop_bytes:]
            self.base += drop_bytes * 8
        self.data = np.concatenate(
            [self.data, np.frombuffer(bytes(more), dtype=np.uint8)])
        self.bit_len = self.base + len(self.data) * 8

    def checkpoint(self) -> int:
        return self.bit_pos

    def restore(self, pos: int):
        self.bit_pos = pos

    def bits_consumed(self) -> int:
        return self.bit_pos

    def bytes_consumed(self) -> int:
        return (self.bit_pos + 7) >> 3

    def read(self, nbits: int) -> int:
        """Read nbits (<= 57) LSB-first."""
        pos = self.bit_pos
        end = pos + nbits
        if end > self.bit_len:
            raise NeedsMoreInput()
        if nbits == 0:
            return 0
        chunk = self.data[(pos - self.base) >> 3:(end - self.base + 7) >> 3]
        val = 0
        for i, b in enumerate(chunk.tolist()):
            val |= b << (8 * i)
        val = (val >> (pos & 7)) & ((1 << nbits) - 1)
        self.bit_pos = end
        return val

    def peek(self, nbits: int) -> int:
        """Peek up to nbits; missing tail bits are zero-filled."""
        pos = self.bit_pos
        byte0 = (pos - self.base) >> 3
        byte1 = min((pos - self.base + nbits + 7) >> 3, len(self.data))
        val = 0
        for i, b in enumerate(self.data[byte0:byte1].tolist()):
            val |= b << (8 * i)
        return (val >> (pos & 7)) & ((1 << nbits) - 1)

    def available(self) -> int:
        return self.bit_len - self.bit_pos

    def bytes_available(self) -> int:
        return (self.bit_len - self.bit_pos) >> 3

    def skip(self, nbits: int):
        if self.bit_pos + nbits > self.bit_len:
            raise NeedsMoreInput()
        self.bit_pos += nbits

    def align_to_byte(self) -> int:
        """Skip to the next byte boundary; returns the skipped bits (the
        caller checks that they are zero)."""
        n = (-self.bit_pos) & 7
        return self.read(n) if n else 0

    def read_bytes(self, n: int) -> bytes:
        """Read n whole bytes (the reader must be byte-aligned)."""
        if self.bit_pos & 7:
            raise ValueError("read_bytes: reader is not byte-aligned")
        if self.bit_pos + 8 * n > self.bit_len:
            raise NeedsMoreInput()
        byte0 = (self.bit_pos - self.base) >> 3
        out = self.data[byte0:byte0 + n].tobytes()
        self.bit_pos += 8 * n
        return out


class BitWriter:
    """LSB-first bit writer into a growable bytearray."""

    __slots__ = ("buf", "bitpos")

    def __init__(self):
        self.buf = bytearray()
        self.bitpos = 0  # bits already used in the last byte (0..7)

    def __len__(self):
        return len(self.buf)

    def bit_length(self) -> int:
        return len(self.buf) * 8 - ((8 - self.bitpos) & 7)

    def write(self, bits: int, nbits: int):
        """Append nbits of `bits`, LSB-first."""
        if nbits == 0:
            return
        assert bits >> nbits == 0, (bits, nbits)
        if self.bitpos:
            space = 8 - self.bitpos
            self.buf[-1] |= (bits << self.bitpos) & 0xFF
            if nbits <= space:
                self.bitpos = (self.bitpos + nbits) & 7
                return
            bits >>= space
            nbits -= space
            self.bitpos = 0
        while nbits >= 8:
            self.buf.append(bits & 0xFF)
            bits >>= 8
            nbits -= 8
        if nbits:
            self.buf.append(bits & 0xFF)
            self.bitpos = nbits

    def write_bytes(self, data: bytes):
        """Append whole bytes (writer must be byte-aligned)."""
        assert self.bitpos == 0
        self.buf += data

    def align_to_byte(self):
        self.bitpos = 0

    def is_byte_aligned(self) -> bool:
        return self.bitpos == 0

    def append_packed(self, words: np.ndarray, total_bits: int):
        """Append a pre-packed little-endian bit buffer: the low
        `total_bits` bits of uint64 `words` (LSB-first, word 0 first)."""
        if total_bits == 0:
            return
        nbytes = (total_bits + 7) >> 3
        # slice to the used words BEFORE the bytes copy: `words` is a
        # reused scratch buffer much larger than the payload
        used = words[:(total_bits + 63) >> 6]
        raw = np.frombuffer(
            np.ascontiguousarray(used, dtype="<u8").tobytes()[:nbytes],
            dtype=np.uint8).copy()
        if total_bits & 7:
            raw[-1] &= (1 << (total_bits & 7)) - 1
        p = self.bitpos
        if p == 0:
            self.buf += raw.tobytes()
            self.bitpos = total_bits & 7
            return
        # Unaligned: shift raw left by p bits across byte boundaries.
        last = self.buf[-1] & ((1 << p) - 1)
        rawpad = np.concatenate([raw, np.zeros(1, np.uint8)]).astype(np.uint16)
        m = (p + total_bits + 7) // 8 - 1  # result bytes after buf[-1]
        tail = (((rawpad[1:] << p) & 0xFF)
                | (rawpad[:-1] >> (8 - p))).astype(np.uint8)[:m]
        self.buf[-1] = last | ((int(raw[0]) << p) & 0xFF)
        self.buf += tail.tobytes()
        self.bitpos = (p + total_bits) & 7
        if self.bitpos:
            self.buf[-1] &= (1 << self.bitpos) - 1

    def append_packed_phased(self, words: np.ndarray, total_bits: int,
                             phase: int):
        """Append a pre-packed buffer assembled at this writer's bit
        phase: its first `phase` bits are zero placeholders for the bits
        already in the writer's partial last byte (self.bitpos must
        equal phase), so the bytes join with one OR on the boundary
        byte."""
        if self.bitpos != phase:
            raise ValueError(f"append_packed_phased: writer at bit "
                             f"{self.bitpos}, buffer at phase {phase}")
        if total_bits <= phase:
            return
        nbytes = (total_bits + 7) >> 3
        used = words[:(total_bits + 63) >> 6]
        raw = np.frombuffer(
            np.ascontiguousarray(used, dtype="<u8").tobytes()[:nbytes],
            dtype=np.uint8)
        if phase == 0:
            self.buf += raw.tobytes()
        else:
            self.buf[-1] |= int(raw[0])
            self.buf += raw[1:].tobytes()
        self.bitpos = total_bits & 7
        if self.bitpos:
            self.buf[-1] &= (1 << self.bitpos) - 1

    def save_state(self):
        """Checkpoint for rollback (per-metablock uncompressed fallback)."""
        return (len(self.buf), self.bitpos,
                self.buf[-1] if self.buf else 0)

    def restore_state(self, state):
        nbytes, bitpos, last = state
        del self.buf[nbytes:]
        if nbytes:
            self.buf[-1] = last
        self.bitpos = bitpos

    def getvalue(self) -> bytes:
        return bytes(self.buf)
