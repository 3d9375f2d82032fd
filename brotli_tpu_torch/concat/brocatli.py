"""BroCatli: lossless bit-level concatenation of brotli streams.

The port's own copy of brotli_tpu/concat/brocatli.py (plain Python, no
torch): compress_mesh merges its shards' streams with it.

Re-implementation (behavior-compatible) of the reference's concatenation
engine (reference src/concat/mod.rs): joins independently-compressed
brotli streams into one valid stream by

- parsing each new stream's window header (all WBITS encodings incl.
  the 14-bit large-window form) and requiring it not exceed the first
  stream's window (mod.rs:39-71);
- locating the first byte-aligned point of the new stream
  (detect_varlen_offset, mod.rs:73-121) — the end of an ISLASTEMPTY /
  metadata header / uncompressed-metablock header — so only the header
  needs bit-shifting and the remainder is copied byte-for-byte;
- sanitizing the previous stream's tail: the trailing '11' empty-last
  metablock bits are found from the top of the final partial byte and
  masked out (flush_previous_stream, mod.rs:277-330), which is why
  inputs must end with the empty-last metablock (appendable/catable
  streams; plain streams fail with BrotliFileNotCraftedForAppend);
- appending the terminal '11' + byte padding at finish (mod.rs:567).

State serializes to the same 21-byte layout as the reference
(serialize_to_buffer/deserialize_from_buffer, mod.rs:199/141) so
concatenation is resumable across processes.
"""

from __future__ import annotations

from enum import IntEnum

NUM_STREAM_HEADER_BYTES = 5


class BroCatliResult(IntEnum):
    Success = 0
    NeedsMoreInput = 1
    NeedsMoreOutput = 2
    BrotliFileNotCraftedForAppend = 124
    InvalidWindowSize = 125
    WindowSizeLargerThanPreviousFile = 126
    BrotliFileNotCraftedForConcatenation = 127


def parse_window_size(header: bytes):
    """(lgwin, bit_offset_past_wbits) from the first stream bytes, or
    None if invalid (reference parse_window_size, concat/mod.rs:39)."""
    if len(header) == 0:
        return None
    b0 = header[0]
    if b0 & 1 == 0:
        return 16, 1
    low4 = b0 & 15
    table4 = {0x3: 18, 0x5: 19, 0x7: 20, 0x9: 21, 0xB: 22, 0xD: 23,
              0xF: 24}
    if low4 in table4:
        return table4[low4], 4
    low7 = b0 & 127
    table7 = {0x71: 15, 0x61: 14, 0x51: 13, 0x41: 12, 0x31: 11,
              0x21: 10, 0x1: 17}
    if low7 in table7:
        return table7[low7], 7
    # large-window 14-bit form: low bits 10001, then 6-bit lgwin
    if b0 & 0x80:
        return None
    if len(header) < 2:
        return None
    w = header[1] & 0x3F
    if not 10 <= w <= 30:
        return None
    return w, 14


def detect_varlen_offset(header: bytes):
    """Bit offset of the first byte-alignable point after the header
    (reference detect_varlen_offset, concat/mod.rs:73).  Requires the
    first metablock to be ISLASTEMPTY, metadata, or uncompressed."""
    parsed = parse_window_size(header)
    if parsed is None:
        return None
    _, offset = parsed
    bits = 0
    for i, b in enumerate(header):
        bits |= b << (8 * i)
    bits >>= offset
    offset += 1
    if bits & 1:  # ISLAST
        bits >>= 1
        offset += 1
        if bits & 1:  # ISLASTEMPTY
            return offset
    bits >>= 1
    mnibbles = bits & 3
    bits >>= 2
    offset += 2
    if mnibbles == 3:  # metadata block
        if bits & 1:
            return None  # reserved bit set
        bits >>= 1
        offset += 1
        mskipbytes = bits & 3
        offset += 2
        offset += mskipbytes * 8
        return offset
    nibbles = mnibbles + 4
    offset += nibbles * 4
    bits >>= nibbles * 4
    offset += 1
    if bits & 1 == 0:
        return None  # not uncompressed: cannot re-align
    return offset


class BroCatli:
    def __init__(self, window_size: int = 0):
        self.last_bytes = bytearray(2)
        self.last_bytes_len = 0
        self.last_byte_sanitized = False
        self.any_bytes_emitted = False
        self.last_byte_bit_offset = 0
        self.window_size = 0
        self.new_stream_pending = None  # dict or None
        if window_size:
            self._init_window(window_size)

    # -- construction ----------------------------------------------------
    def _init_window(self, lgwin: int):
        """Seed last_bytes as if an empty stream with this window had
        been emitted (reference new_with_window_size, mod.rs:229)."""
        if lgwin > 30 or lgwin < 10:
            raise ValueError("invalid window size")
        if lgwin > 24:
            self.last_bytes[:2] = bytes([17, lgwin | 64 | 128])
            self.last_bytes_len = 2
        elif lgwin == 16:
            self.last_bytes[:2] = bytes([1 | 2 | 4, 0])
            self.last_bytes_len = 1
        elif lgwin > 17:
            self.last_bytes[:2] = bytes([(3 + (lgwin - 18) * 2) | 48, 0])
            self.last_bytes_len = 1
        else:
            first = {15: 0x71, 14: 0x61, 13: 0x51, 12: 0x41, 11: 0x31,
                     10: 0x21, 17: 0x1}[lgwin] | 0x80
            self.last_bytes[:2] = bytes([first, 1])
            self.last_bytes_len = 2
        self.window_size = lgwin

    # -- persistence (same 21-byte layout as the reference) --------------
    def serialize_to_buffer(self) -> bytes:
        buf = bytearray(16 + NUM_STREAM_HEADER_BYTES)
        buf[0:2] = self.last_bytes
        buf[8] = self.last_bytes_len
        buf[9] = (int(self.last_byte_sanitized)
                  | ((self.new_stream_pending is not None) << 6)
                  | (int(self.any_bytes_emitted) << 5))
        buf[10] = self.last_byte_bit_offset
        buf[11] = self.window_size
        if self.new_stream_pending is not None:
            p = self.new_stream_pending
            if p["written"] is not None:
                buf[9] |= 1 << 7
            buf[12] = p["read"]
            buf[13] = p["written"] or 0
            buf[16:16 + NUM_STREAM_HEADER_BYTES] = p["bytes"]
        return bytes(buf)

    @classmethod
    def deserialize_from_buffer(cls, buf: bytes) -> "BroCatli":
        if len(buf) < 16 + NUM_STREAM_HEADER_BYTES:
            raise ValueError("buffer too short")
        last_bytes_len = buf[8]
        last_byte_bit_offset = buf[10]
        window_size = buf[11]
        if last_bytes_len > 2 or last_byte_bit_offset >= 8:
            raise ValueError("corrupt state")
        if window_size != 0 and not (10 <= window_size <= 30):
            raise ValueError("corrupt window size")
        has_pending = (buf[9] & (1 << 6)) != 0
        has_written = (buf[9] & (1 << 7)) != 0
        if has_pending:
            if buf[12] > NUM_STREAM_HEADER_BYTES:
                raise ValueError("corrupt pending length")
            if has_written and buf[13] > buf[12]:
                raise ValueError("corrupt pending written")
        ret = cls()
        ret.last_bytes = bytearray(buf[0:2])
        ret.last_bytes_len = last_bytes_len
        ret.last_byte_sanitized = (buf[9] & 1) != 0
        ret.any_bytes_emitted = (buf[9] & (1 << 5)) != 0
        ret.last_byte_bit_offset = last_byte_bit_offset
        ret.window_size = window_size
        if has_pending:
            ret.new_stream_pending = {
                "read": buf[12],
                "written": buf[13] if has_written else None,
                "bytes": bytearray(buf[16:16 + NUM_STREAM_HEADER_BYTES]),
            }
        return ret

    # -- streaming -------------------------------------------------------
    def new_brotli_file(self):
        self.new_stream_pending = {
            "read": 0, "written": None,
            "bytes": bytearray(NUM_STREAM_HEADER_BYTES)}

    def _flush_previous_stream(self) -> BroCatliResult:
        if self.last_byte_sanitized:
            return BroCatliResult.Success
        if self.last_bytes_len == 0:  # first stream
            self.last_byte_sanitized = True
            return BroCatliResult.Success
        last = self.last_bytes[0] | (self.last_bytes[1] << 8)
        maxbit = self.last_bytes_len * 8
        index = 0
        for i in range(maxbit - 1, -1, -1):
            if last & (1 << i):
                index = i
                break
        if index == 0:
            return BroCatliResult.BrotliFileNotCraftedForAppend
        if (last >> (index - 1)) != 3:
            return BroCatliResult.BrotliFileNotCraftedForAppend
        index -= 1
        last &= (1 << index) - 1
        self.last_bytes[0] = last & 0xFF
        self.last_bytes[1] = (last >> 8) & 0xFF
        if index >= 8:
            self._out.append(self.last_bytes[0])
            self.any_bytes_emitted = True
            self.last_bytes[0] = self.last_bytes[1]
            self.last_bytes[1] = 0
            index -= 8
            self.last_bytes_len -= 1
        elif self.last_bytes_len == 2:
            # the '11' straddled the byte boundary: the top byte is now
            # empty, keep only the partial low byte
            self.last_bytes[1] = 0
            self.last_bytes_len = 1
        self.last_byte_bit_offset = index
        self.last_byte_sanitized = True
        return BroCatliResult.Success

    def _shift_new_stream_header(self) -> BroCatliResult:
        p = self.new_stream_pending
        if p["written"] is None:
            head = bytes(p["bytes"][:p["read"]])
            parsed = parse_window_size(head)
            if parsed is None:
                return BroCatliResult.InvalidWindowSize
            window_size, window_offset = parsed
            if self.window_size == 0:
                # first stream: copy verbatim
                self.window_size = window_size
                self._out.append(p["bytes"][0])
                self.any_bytes_emitted = True
                p["written"] = 1
            else:
                if window_size > self.window_size:
                    return BroCatliResult.WindowSizeLargerThanPreviousFile
                voff = detect_varlen_offset(head)
                if voff is None:
                    return \
                        BroCatliResult.BrotliFileNotCraftedForConcatenation
                bits = 0
                for i in range(p["read"]):
                    bits |= p["bytes"][i] << (8 * i)
                bits >>= window_offset
                bits &= (1 << (voff - window_offset)) - 1
                # merge the unaligned header bits after the held byte
                realigned = bytearray(NUM_STREAM_HEADER_BYTES + 1)
                realigned[0] = self.last_bytes[0]
                var_len_bytes = (voff - window_offset + 7) // 8
                sh = self.last_byte_bit_offset
                for bi in range(var_len_bytes):
                    cur = (bits >> (8 * bi)) & 0xFF
                    realigned[bi] |= (cur << sh) & 0xFF
                    realigned[bi + 1] = (cur >> (8 - sh)) & 0xFF \
                        if sh else 0
                dst = (sh + voff - window_offset + 7) // 8
                src = (voff + 7) // 8
                if src > p["read"]:
                    return \
                        BroCatliResult.BrotliFileNotCraftedForConcatenation
                ncopy = p["read"] - src
                realigned[dst:dst + ncopy] = p["bytes"][src:src + ncopy]
                self._out.append(realigned[0])
                self.any_bytes_emitted = True
                p["read"] = dst + ncopy - 1
                p["written"] = 0
                p["bytes"] = bytearray(realigned[1:])
        to_copy = p["read"] - p["written"]
        if to_copy:
            self._out += p["bytes"][p["written"]:p["read"]]
            self.any_bytes_emitted = True
            p["written"] = p["read"]
        self.new_stream_pending = None
        self.last_byte_sanitized = False
        self.last_byte_bit_offset = 0
        # hold back the final emitted byte: its tail may need sanitizing
        self.last_bytes = bytearray([self._out.pop(), 0])
        self.last_bytes_len = 1
        return BroCatliResult.Success

    def stream(self, in_bytes: bytes, out: bytearray) -> BroCatliResult:
        """Feed one whole input chunk; appends output to `out`
        (unbounded-output convenience form of the reference's
        stream(), concat/mod.rs:450)."""
        self._out = out
        pos = 0
        if self.new_stream_pending is not None:
            res = self._flush_previous_stream()
            if res != BroCatliResult.Success:
                return res
            p = self.new_stream_pending
            need = NUM_STREAM_HEADER_BYTES - p["read"]
            take = min(need, len(in_bytes) - pos)
            p["bytes"][p["read"]:p["read"] + take] = \
                in_bytes[pos:pos + take]
            p["read"] += take
            pos += take
            sufficient = (p["read"] == NUM_STREAM_HEADER_BYTES or
                          (p["read"] == 4 and
                           (p["bytes"][0] & 127) != 17))
            if not sufficient:
                return BroCatliResult.NeedsMoreInput
            res = self._shift_new_stream_header()
            if res != BroCatliResult.Success:
                return res
        # stream body: emit everything except the trailing 2 bytes,
        # which stay held for end-of-stream sanitization
        combined = bytes(self.last_bytes[:self.last_bytes_len]) \
            + bytes(in_bytes[pos:])
        if len(combined) > 2:
            self._out += combined[:-2]
            self.any_bytes_emitted = True
        held = combined[-2:]
        self.last_bytes = bytearray(held + bytes(2 - len(held)))
        self.last_bytes_len = len(held)
        return BroCatliResult.NeedsMoreInput

    def finish(self, out: bytearray) -> BroCatliResult:
        self._out = out
        if self.new_stream_pending is not None:
            # a pending that never reached sufficiency is a complete
            # tiny stream, and only EMPTY-content streams fit in < 4
            # bytes — drop it like the reference does (its finish,
            # concat/mod.rs:581, never touches the pending; shifting a
            # fully-buffered 2-byte stream here would split its
            # trailing '11' across the held byte and the emitted one
            # and then fail sanitization)
            self.new_stream_pending = None
        if not self.last_byte_sanitized:
            res = self._flush_previous_stream()
            if res != BroCatliResult.Success:
                return res
        if self.last_byte_sanitized and self.last_bytes_len != 0:
            self._append_eof_metablock()
        while self.last_bytes_len:
            out.append(self.last_bytes[0])
            self.last_bytes[0] = self.last_bytes[1]
            self.last_bytes_len -= 1
            self.any_bytes_emitted = True
        if not self.any_bytes_emitted:
            out.append(ord(";"))
            self.any_bytes_emitted = True
        return BroCatliResult.Success

    def _append_eof_metablock(self):
        last = self.last_bytes[0] | (self.last_bytes[1] << 8)
        bit_end = (self.last_bytes_len - 1) * 8 + self.last_byte_bit_offset
        last |= 3 << bit_end
        self.last_bytes[0] = last & 0xFF
        self.last_bytes[1] = (last >> 8) & 0xFF
        self.last_byte_sanitized = False
        self.last_byte_bit_offset += 2
        if self.last_byte_bit_offset >= 8:
            self.last_byte_bit_offset -= 8
            self.last_bytes_len += 1


def concatenate(streams, window_size: int = 0) -> bytes:
    """High-level helper: concatenate complete brotli streams
    (each appendable/catable-shaped) into one stream."""
    bc = BroCatli(window_size)
    out = bytearray()
    for s in streams:
        bc.new_brotli_file()
        res = bc.stream(bytes(s), out)
        if res not in (BroCatliResult.NeedsMoreInput,
                       BroCatliResult.Success):
            raise ValueError(f"concat failed: {res.name}")
    res = bc.finish(out)
    if res != BroCatliResult.Success:
        raise ValueError(f"concat finish failed: {res.name}")
    return bytes(out)
