"""RFC 7932 Brotli decoder on the host: the one-shot Decoder, the header
field readers and the decode entry.

A copy of brotli_tpu/decode/decoder.py's one-shot core: the stream
header (large windows too), metadata, uncompressed and compressed
metablocks with block switching, context modeling, context maps (with
RLE and inverse move-to-front), prefix codes, the distance cache, and
the static and custom dictionaries.  The batch decoder's header walk
(batch_gpu.py) reads the count codes, window bits and context maps from
here.  `decompress` decodes with the native runtime; the Decoder class
is pure Python, the JAX package's fallback where its runtime does not
build, and decodes the same streams with the same errors.  The command
loop also runs resumably, one command at a time with a rollback point
before each, for the streaming decoder (stream.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import constants as C
from ..core.bitio import BitReader, NeedsMoreInput
from ..core.dictionary import get_dictionary
from ..core.prefix import PrefixDecoder, read_prefix_code


class BrotliDecodeError(Exception):
    pass


def _read_count_code(reader) -> int:
    """NBLTYPES / NTREES variable-length count (RFC 9.2)."""
    if reader.read(1) == 0:
        return 1
    nbits = reader.read(3)
    return (1 << nbits) + 1 + reader.read(nbits)


def _read_window_bits(reader, large_window: bool = False) -> int:
    """WBITS; the large-window header only where large_window."""
    if reader.read(1) == 0:
        return 16
    n = reader.read(3)
    if n != 0:
        return 17 + n
    m = reader.read(3)
    if m == 0:
        return 17
    if m == 1:
        if not large_window:
            raise BrotliDecodeError("reserved WBITS pattern (large window?)")
        if reader.read(1):
            raise BrotliDecodeError("reserved large-window bit set")
        w = reader.read(6)
        if not (C.MIN_WINDOW_BITS <= w <= C.LARGE_MAX_WINDOW_BITS):
            raise BrotliDecodeError(f"invalid large window bits {w}")
        return w
    return 8 + m


def _read_block_switch_count(reader, blen_dec: PrefixDecoder) -> int:
    sym = blen_dec.decode(reader)
    return int(C.BLOCK_LEN_BASE[sym]) + reader.read(int(C.BLOCK_LEN_EXTRA[sym]))


def _inverse_mtf(values: np.ndarray) -> np.ndarray:
    mtf = list(range(256))
    out = np.empty_like(values)
    for i, v in enumerate(values):
        x = mtf[v]
        out[i] = x
        if v:
            del mtf[v]
            mtf.insert(0, x)
    return out


def _read_context_map(reader, num_contexts: int, ntrees: int) -> np.ndarray:
    cmap = np.zeros(num_contexts, dtype=np.int64)
    if ntrees < 2:
        return cmap
    rlemax = (reader.read(4) + 1) if reader.read(1) else 0
    dec = PrefixDecoder(read_prefix_code(reader, ntrees + rlemax))
    i = 0
    while i < num_contexts:
        sym = dec.decode(reader)
        if sym == 0:
            i += 1
        elif sym <= rlemax:
            reps = (1 << sym) + reader.read(sym)
            if i + reps > num_contexts:
                raise BrotliDecodeError("context map RLE overrun")
            i += reps  # zeros (cmap already zero)
        else:
            cmap[i] = sym - rlemax
            i += 1
    if reader.read(1):
        cmap = _inverse_mtf(cmap)
    if cmap.max(initial=0) >= ntrees:
        raise BrotliDecodeError("context map value out of range")
    return cmap


@dataclass
class _BlockCategory:
    """Block-switching state for one category (RFC section 6)."""
    num_types: int = 1
    cur: int = 0
    prev: int = 1
    remaining: int = 1 << 60
    type_dec: PrefixDecoder | None = None
    len_dec: PrefixDecoder | None = None

    def read_header(self, reader):
        self.num_types = _read_count_code(reader)
        self.cur, self.prev = 0, 1
        if self.num_types >= 2:
            self.type_dec = PrefixDecoder(
                read_prefix_code(reader, self.num_types + 2))
            self.len_dec = PrefixDecoder(
                read_prefix_code(reader, C.NUM_BLOCK_LEN_SYMBOLS))
            self.remaining = _read_block_switch_count(reader, self.len_dec)
        else:
            self.remaining = 1 << 60

    def switch(self, reader):
        sym = self.type_dec.decode(reader)
        if sym == 0:
            new = self.prev
        elif sym == 1:
            new = (self.cur + 1) % self.num_types
        else:
            new = sym - 2
        self.prev, self.cur = self.cur, new
        self.remaining = _read_block_switch_count(reader, self.len_dec)

    def tick(self, reader):
        if self.remaining == 0:
            self.switch(reader)
        self.remaining -= 1


class Decoder:
    """The one-shot RFC 7932 decoder core in pure Python."""

    def __init__(self, custom_dictionary: bytes = b"",
                 large_window: bool = False):
        self.custom_dictionary = bytes(custom_dictionary)
        self.large_window = large_window

    def decompress(self, data, max_output=None) -> bytes:
        reader = BitReader(data)
        try:
            return self.decompress_reader(reader, max_output=max_output)
        except ValueError as e:  # corrupt prefix codes etc.
            raise BrotliDecodeError(str(e)) from e

    def decompress_reader(self, reader: BitReader, max_output=None) -> bytes:
        out = bytearray()
        dict_bytes = self.custom_dictionary
        wbits = _read_window_bits(reader, self.large_window)
        window_size = (1 << wbits) - 16
        dist_cache = list(C.INITIAL_DISTANCE_CACHE)
        static_dict = get_dictionary()

        while True:
            islast = reader.read(1)
            if islast and reader.read(1):  # ISLASTEMPTY
                break
            mnibbles = reader.read(2)
            if mnibbles == 3:
                # Metadata / empty metablock (RFC 9.2); may also be last.
                if reader.read(1):
                    raise BrotliDecodeError("reserved bit set")
                mskipbytes = reader.read(2)
                if mskipbytes == 0:
                    skip = 0
                else:
                    val = reader.read(8 * mskipbytes)
                    if mskipbytes > 1 and (val >> (8 * (mskipbytes - 1))) == 0:
                        raise BrotliDecodeError("non-minimal MSKIPLEN")
                    skip = val + 1
                pad = reader.align_to_byte()
                if pad:
                    raise BrotliDecodeError("nonzero padding before metadata")
                reader.read_bytes(skip)
                if islast:
                    break
                continue
            mlen = reader.read(16 + 4 * mnibbles) + 1
            if mnibbles > 0 and (mlen - 1) >> (16 + 4 * (mnibbles - 1)) == 0:
                raise BrotliDecodeError("non-minimal MNIBBLES")
            if not islast and reader.read(1):  # ISUNCOMPRESSED
                # RFC 7932 §9.2: alignment bits must be zero
                if reader.align_to_byte() != 0:
                    raise BrotliDecodeError(
                        "nonzero padding before uncompressed block")
                out += reader.read_bytes(mlen)
                continue

            self._decode_compressed_metablock(
                reader, out, mlen, window_size, dist_cache,
                dict_bytes, static_dict)
            if max_output is not None and len(out) > max_output:
                raise BrotliDecodeError("output limit exceeded")
            if islast:
                break
        # RFC 7932 §9.2: the padding bits after the last metablock up
        # to the next byte boundary must be zero (the reference
        # decoder rejects nonzero final padding; trailing BYTES after
        # the aligned boundary stay tolerated)
        if reader.align_to_byte() != 0:
            raise BrotliDecodeError("nonzero padding after last "
                                    "metablock")
        return bytes(out)

    def _parse_metablock_header(self, reader, mlen):
        """A compressed metablock's header, parsed into its state
        (tables and context maps do not change once parsed)."""
        blocks = {c: _BlockCategory() for c in "LID"}
        for c in "LID":
            blocks[c].read_header(reader)

        npostfix = reader.read(2)
        ndirect = reader.read(4) << npostfix
        context_modes = [reader.read(2)
                         for _ in range(blocks["L"].num_types)]

        ntrees_l = _read_count_code(reader)
        cmap_l = _read_context_map(
            reader, 64 * blocks["L"].num_types, ntrees_l)
        ntrees_d = _read_count_code(reader)
        cmap_d = _read_context_map(
            reader, 4 * blocks["D"].num_types, ntrees_d)

        max_distbits = 62 if self.large_window else 24
        dist_alphabet = C.distance_alphabet_size(npostfix, ndirect,
                                                 max_distbits)

        lit_decs = [PrefixDecoder(read_prefix_code(reader, 256))
                    for _ in range(ntrees_l)]
        cmd_decs = [PrefixDecoder(read_prefix_code(reader, 704))
                    for _ in range(blocks["I"].num_types)]
        dist_decs = [PrefixDecoder(read_prefix_code(reader, dist_alphabet))
                     for _ in range(ntrees_d)]
        return _MetablockState(
            blocks=blocks, npostfix=npostfix, ndirect=ndirect,
            context_modes=context_modes, cmap_l=cmap_l, cmap_d=cmap_d,
            lit_decs=lit_decs, cmd_decs=cmd_decs, dist_decs=dist_decs,
            mlen=mlen)

    def _decode_compressed_metablock(self, reader, out, mlen, window_size,
                                     dist_cache, dict_bytes, static_dict):
        st = self._parse_metablock_header(reader, mlen)
        self._run_commands(reader, out, st, window_size, dist_cache,
                           dict_bytes, static_dict)

    def _run_commands(self, reader, out, st, window_size, dist_cache,
                      dict_bytes, static_dict, resumable=False,
                      out_limit=None):
        """Decode the commands of one metablock into `out`.  With
        resumable=True the loop checkpoints before every command: where
        the input runs out it rolls back at most that command (into st)
        and raises NeedsMoreInput; with out_limit set it suspends with
        NeedsMoreOutput once the total output reaches the limit, st left
        mid-block."""
        L, I, D = st.blocks["L"], st.blocks["I"], st.blocks["D"]
        dlen = len(dict_bytes)

        def prev_byte(k):
            """The k-th previous output byte (1-based), reaching into
            the custom dictionary; 0 before the stream's start."""
            if len(out) >= k:
                return out[-k]
            i = dlen - (k - len(out))
            return dict_bytes[i] if i >= 0 else 0

        mlen = st.mlen
        while mlen > 0:
            if resumable:
                if out_limit is not None and len(out) >= out_limit:
                    st.mlen = mlen
                    raise NeedsMoreOutput()
                ckpt = (reader.checkpoint(), len(out), list(dist_cache),
                        mlen, (L.cur, L.prev, L.remaining),
                        (I.cur, I.prev, I.remaining),
                        (D.cur, D.prev, D.remaining))
            try:
                mlen = self._one_command(
                    reader, out, mlen, window_size, dist_cache, dict_bytes,
                    static_dict, st, prev_byte(1), prev_byte(2), prev_byte)
            except NeedsMoreInput:
                if not resumable:
                    raise
                reader.restore(ckpt[0])
                del out[ckpt[1]:]
                dist_cache[:] = ckpt[2]
                st.mlen = ckpt[3]
                (L.cur, L.prev, L.remaining) = ckpt[4]
                (I.cur, I.prev, I.remaining) = ckpt[5]
                (D.cur, D.prev, D.remaining) = ckpt[6]
                raise
        st.mlen = 0

    def _one_command(self, reader, out, mlen, window_size, dist_cache,
                     dict_bytes, static_dict, st, p1, p2, prev_byte):
        """Decode one command (its literals, then its copy or dictionary
        word); returns the metablock's bytes still to come."""
        npostfix, ndirect = st.npostfix, st.ndirect
        L, I, D = st.blocks["L"], st.blocks["I"], st.blocks["D"]
        lut0, lut1 = C.CONTEXT_LUT0, C.CONTEXT_LUT1
        dlen = len(dict_bytes)
        cmap_l, cmap_d = st.cmap_l, st.cmap_d
        I.tick(reader)
        cmd_sym = st.cmd_decs[I.cur].decode(reader)
        ins_code = int(C.CMD_TO_INSERT_CODE[cmd_sym])
        copy_code = int(C.CMD_TO_COPY_CODE[cmd_sym])
        ins_len = int(C.INSERT_BASE[ins_code]) + reader.read(
            int(C.INSERT_EXTRA[ins_code]))
        copy_len = int(C.COPY_BASE[copy_code]) + reader.read(
            int(C.COPY_EXTRA[copy_code]))

        if ins_len > mlen:
            raise BrotliDecodeError("insert overruns metablock")
        for _ in range(ins_len):
            L.tick(reader)
            mode = st.context_modes[L.cur]
            ctx = int(lut0[mode][p1]) | int(lut1[mode][p2])
            tree = int(cmap_l[(L.cur << 6) | ctx])
            lit = st.lit_decs[tree].decode(reader)
            out.append(lit)
            p2, p1 = p1, lit
        mlen -= ins_len
        if mlen == 0:
            return 0  # copy part of the final command is ignored

        pos_total = len(out) + dlen
        max_distance = min(pos_total, window_size)

        if C.CMD_IMPLICIT_DIST0[cmd_sym]:
            distance = dist_cache[0]
            dcode = 0
        else:
            D.tick(reader)
            dctx = int(C.distance_context_from_copy_len(copy_len))
            tree = int(cmap_d[(D.cur << 2) | dctx])
            dcode = st.dist_decs[tree].decode(reader)
            if dcode < 16:
                idx = int(C.DISTANCE_SHORT_CODE_INDEX[dcode])
                delta = int(C.DISTANCE_SHORT_CODE_DELTA[dcode])
                distance = dist_cache[idx] + delta
                if distance <= 0:
                    raise BrotliDecodeError("invalid short-code distance")
            elif dcode < 16 + ndirect:
                distance = dcode - 16 + 1
            else:
                nbits = int(C.num_distance_extra_bits(
                    dcode, npostfix, ndirect))
                extra = reader.read(nbits)
                distance = int(C.decode_distance(
                    dcode, npostfix, ndirect, extra))

        if distance > max_distance:
            # Static dictionary reference (RFC 8).
            if not (C.MIN_DICTIONARY_WORD_LENGTH <= copy_len
                    <= C.MAX_DICTIONARY_WORD_LENGTH):
                raise BrotliDecodeError(
                    f"invalid dictionary copy length {copy_len} "
                    f"(pos={len(out)} dist={distance} dcode={dcode} "
                    f"max_dist={max_distance} cache={dist_cache})")
            word_id = distance - max_distance - 1
            try:
                word = static_dict.resolve(copy_len, word_id)
            except ValueError as e:
                raise BrotliDecodeError(str(e)) from e
            if len(word) > mlen:
                raise BrotliDecodeError("dictionary word overruns block")
            out += word
            mlen -= len(word)
            p1, p2 = prev_byte(1), prev_byte(2)
        else:
            if copy_len > mlen:
                raise BrotliDecodeError("copy overruns metablock")
            _backward_copy(out, distance, copy_len, dict_bytes)
            mlen -= copy_len
            p1, p2 = prev_byte(1), prev_byte(2)
            if dcode != 0:
                dist_cache.pop()
                dist_cache.insert(0, distance)
        return mlen


class NeedsMoreOutput(Exception):
    """Raised by the resumable command loop when the output limit is
    reached mid-metablock (the reference's BrotliResult
    NeedsMoreOutput)."""


@dataclass
class _MetablockState:
    """One compressed metablock's header: its block-switch state, tables
    and context maps, and the bytes still to decode."""
    blocks: dict
    npostfix: int
    ndirect: int
    context_modes: list
    cmap_l: np.ndarray
    cmap_d: np.ndarray
    lit_decs: list
    cmd_decs: list
    dist_decs: list
    mlen: int


def _backward_copy(out: bytearray, distance: int, copy_len: int,
                   dict_bytes: bytes):
    """Copy copy_len bytes from distance back; may reach into the custom
    dictionary; handles overlap with repeating semantics."""
    start = len(out) - distance
    if start < 0:
        # part (or all) comes from the custom dictionary
        dstart = len(dict_bytes) + start
        if dstart < 0:
            raise BrotliDecodeError("distance beyond window/dictionary")
        take = min(copy_len, -start)
        out += dict_bytes[dstart:dstart + take]
        copy_len -= take
        if copy_len == 0:
            return
        start = len(out) - distance
    while copy_len > 0:
        avail = len(out) - start
        take = min(copy_len, avail)
        out += bytes(out[start:start + take])
        start += take
        copy_len -= take


def decompress(data, custom_dictionary: bytes = b"",
               large_window: bool = False) -> bytes:
    """One-shot decompress with the native decoder (trailing garbage
    after the last block is ignored).  Raises NeedsMoreInput for a
    truncated stream and BrotliDecodeError for a corrupt one; where the
    native runtime is not in use, Decoder decodes instead."""
    from .. import native_bridge as nb
    if not nb.available():
        return Decoder(custom_dictionary, large_window).decompress(data)
    try:
        return nb.decode(data, custom_dictionary, large_window)
    except ValueError as e:
        code = e.args[0] if e.args else -2
        if code == -1:
            raise NeedsMoreInput() from None
        raise BrotliDecodeError(
            f"corrupt stream (native code {code})") from None
