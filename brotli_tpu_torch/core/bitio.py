"""LSB-first bit writer for the RFC 7932 stream (host side).

A trimmed copy of brotli_tpu/core/bitio.py's BitWriter: headers,
whole-byte stores, the append of natively packed metablocks, and the
checkpoint that rolls a metablock back for the uncompressed fallback.
"""

from __future__ import annotations

import numpy as np


class BitWriter:
    """LSB-first bit writer into a growable bytearray."""

    __slots__ = ("buf", "bitpos")

    def __init__(self):
        self.buf = bytearray()
        self.bitpos = 0  # bits already used in the last byte (0..7)

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
