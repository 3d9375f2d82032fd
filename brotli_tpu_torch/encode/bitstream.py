"""Metablock serialization on the host.

A trimmed copy of brotli_tpu/encode/bitstream.py: the window header,
MLEN, the empty last, padding and metadata metablocks, the
magic-number header, the uncompressed metablock (the store for spans
whose compressed form would be larger), the trivial metablock -- one
prefix code per category, its symbol stream built as (bits, nbits)
item arrays in stream order and packed by the native runtime -- and
the optimized metablock of the native planner (store_meta_block_auto).
"""

from __future__ import annotations

import numpy as np

from .. import native_bridge as nb
from ..core import constants as C
from ..core.bitio import BitWriter
from ..core.huffman import build_huffman_lengths
from ..core.prefix import encoding_table, write_prefix_code
from .command import CommandArrays, command_extra_bits


def write_stream_header(writer: BitWriter, lgwin: int,
                        large_window: bool = False):
    bits, nbits = C.encode_window_bits(lgwin, large_window)
    writer.write(bits, nbits)


def write_mlen(writer: BitWriter, mlen: int):
    """MNIBBLES + MLEN (RFC 7932 section 9.2)."""
    assert 1 <= mlen <= (1 << 24)
    lg = (mlen - 1).bit_length() if mlen > 1 else 1
    mnibbles = max(4, (lg + 3) // 4)
    writer.write(mnibbles - 4, 2)
    writer.write(mlen - 1, mnibbles * 4)


def write_empty_last_meta_block(writer: BitWriter):
    writer.write(1, 1)  # ISLAST
    writer.write(1, 1)  # ISLASTEMPTY


def write_padding_meta_block(writer: BitWriter):
    """Empty (non-last) metadata block used for byte alignment
    (reference BrotliWritePaddingMetaBlock)."""
    writer.write(0, 1)   # ISLAST
    writer.write(3, 2)   # MNIBBLES == 0 -> metadata
    writer.write(0, 1)   # reserved
    writer.write(0, 2)   # MSKIPBYTES = 0
    writer.align_to_byte()


def write_metadata_meta_block(writer: BitWriter, payload: bytes):
    """A skippable metadata metablock carrying `payload` (reference
    BrotliWriteMetadataMetaBlock)."""
    n = len(payload)
    if n >= 1 << 24:
        raise ValueError(f"metadata of {n} bytes: at most 2^24 - 1")
    writer.write(0, 1)   # ISLAST
    writer.write(3, 2)   # MNIBBLES == 0
    writer.write(0, 1)   # reserved
    if n == 0:
        writer.write(0, 2)
    else:
        nbytes = max(1, ((n - 1).bit_length() + 7) // 8)
        writer.write(nbytes, 2)
        writer.write(n - 1, 8 * nbytes)
    writer.align_to_byte()
    if n:
        writer.write_bytes(payload)


FORMAT_VERSION = 1


def encode_base_128(value: int) -> bytes:
    """LEB128-style size-hint encoding (reference encode_base_128)."""
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        out.append(b | (0x80 if value else 0))
        if not value:
            return bytes(out)


def write_magic_number(writer: BitWriter, size_hint: int = 0,
                       catable: bool = False, appendable: bool = False):
    """Dropbox magic-number header: a metadata block after the window
    header carrying magic + version + base-128 size hint."""
    hint = encode_base_128(size_hint)
    writer.write(0, 1)    # ISLAST
    writer.write(3, 2)    # MNIBBLES == 0 -> metadata
    writer.write(0, 1)    # reserved
    writer.write(1, 2)    # MSKIPBYTES = 1
    writer.write(3 + len(hint), 8)  # MSKIPLEN - 1
    writer.align_to_byte()
    if catable:
        magic = bytes([0xE1, 0x97, 0x81])
    elif appendable:
        magic = bytes([0xE1, 0x97, 0x82])
    else:
        magic = bytes([0xE1, 0x97, 0x80])
    writer.write_bytes(magic + bytes([FORMAT_VERSION]) + hint)


def store_uncompressed_meta_block(writer: BitWriter, data: bytes):
    """ISUNCOMPRESSED metablock; the caller appends the empty last
    block if this ends the stream (uncompressed blocks cannot be
    ISLAST)."""
    mlen = len(data)
    assert 1 <= mlen <= (1 << 24)
    writer.write(0, 1)   # ISLAST
    write_mlen(writer, mlen)
    writer.write(1, 1)   # ISUNCOMPRESSED
    writer.align_to_byte()
    writer.write_bytes(bytes(data))


def extract_literals(data: np.ndarray, start: int, insert_len,
                     advance) -> np.ndarray:
    """The literal bytes of a command stream that starts at data[start]
    (each command covers insert_len + advance bytes), vectorized."""
    ins = np.asarray(insert_len, np.int64)
    adv = np.asarray(advance, np.int64)
    total = int(ins.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8)
    cmd_start = np.zeros(len(ins), dtype=np.int64)
    np.cumsum((ins + adv)[:-1], out=cmd_start[1:])
    # owning command of each literal + offset within its run
    owner = np.repeat(np.arange(len(ins)), ins)
    run_off = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(ins)[:-1]]), ins)
    return np.asarray(data)[start + cmd_start[owner] + run_off]


def _safe_hist(hist: np.ndarray) -> np.ndarray:
    if hist.sum() == 0:
        hist = hist.copy()
        hist[0] = 1
    return hist


def store_meta_block_trivial(writer: BitWriter, data: np.ndarray,
                             start: int, mlen: int, is_last: bool,
                             cmds: CommandArrays, dist_params):
    """Serialize one compressed metablock with one prefix code per
    category (reference store_meta_block_trivial,
    brotli_bit_stream.rs:2349)."""
    literals = extract_literals(data, start, cmds.insert_len,
                                cmds.copy_advance)
    dist_mask = (cmds.copy_len > 0) & ~C.CMD_IMPLICIT_DIST0[cmds.cmd_sym]
    dist_syms = cmds.dist_code[dist_mask]

    lit_hist = _safe_hist(np.bincount(literals, minlength=256))
    cmd_hist = _safe_hist(np.bincount(cmds.cmd_sym, minlength=704))
    dist_hist = _safe_hist(np.bincount(
        dist_syms, minlength=dist_params.alphabet_size))

    lit_lengths = build_huffman_lengths(lit_hist)
    cmd_lengths = build_huffman_lengths(cmd_hist)
    dist_lengths = build_huffman_lengths(dist_hist)

    writer.write(1 if is_last else 0, 1)
    if is_last:
        writer.write(0, 1)  # ISLASTEMPTY = 0
    write_mlen(writer, mlen)
    if not is_last:
        writer.write(0, 1)  # ISUNCOMPRESSED = 0
    for _ in range(3):      # NBLTYPES L/I/D = 1
        writer.write(0, 1)
    writer.write(dist_params.npostfix, 2)
    writer.write(dist_params.ndirect >> dist_params.npostfix, 4)
    writer.write(0, 2)      # context mode of the one literal block type
    writer.write(0, 1)      # NTREESL = 1
    writer.write(0, 1)      # NTREESD = 1
    write_prefix_code(writer, lit_lengths)
    write_prefix_code(writer, cmd_lengths)
    write_prefix_code(writer, dist_lengths)
    emit_command_stream(writer, cmds, literals, lit_lengths, cmd_lengths,
                        dist_lengths)


def emit_command_stream(writer: BitWriter, cmds: CommandArrays,
                        literals: np.ndarray, lit_lengths, cmd_lengths,
                        dist_lengths):
    """Emit the interleaved symbol stream of a one-code-per-category
    metablock, vectorized: per command its symbol, insert/copy extra
    bits, literals, then distance symbol + extra bits unless the
    command implies distance 0."""
    n = len(cmds)
    ins_val, ins_nb, copy_val, copy_nb = command_extra_bits(cmds)
    dist_mask = (cmds.copy_len > 0) & ~C.CMD_IMPLICIT_DIST0[cmds.cmd_sym]

    items_per_cmd = 3 + cmds.insert_len + 2 * dist_mask
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(items_per_cmd[:-1], out=offs[1:])
    total_items = int(items_per_cmd.sum())
    bits = np.zeros(total_items, dtype=np.uint64)
    nbits = np.zeros(total_items, dtype=np.int64)

    cmd_code_b, cmd_code_n = encoding_table(cmd_lengths)
    bits[offs] = cmd_code_b[cmds.cmd_sym].astype(np.uint64)
    nbits[offs] = cmd_code_n[cmds.cmd_sym]
    bits[offs + 1] = ins_val.astype(np.uint64)
    nbits[offs + 1] = ins_nb
    bits[offs + 2] = copy_val.astype(np.uint64)
    nbits[offs + 2] = copy_nb

    n_lit = len(literals)
    if n_lit:
        owner = np.repeat(np.arange(n), cmds.insert_len)
        run_off = np.arange(n_lit) - np.repeat(
            np.concatenate([[0], np.cumsum(cmds.insert_len)[:-1]]),
            cmds.insert_len)
        lit_pos = offs[owner] + 3 + run_off
        lit_code_b, lit_code_n = encoding_table(lit_lengths)
        bits[lit_pos] = lit_code_b[literals].astype(np.uint64)
        nbits[lit_pos] = lit_code_n[literals]

    d_idx = np.nonzero(dist_mask)[0]
    if len(d_idx):
        d_pos = offs[d_idx] + 3 + cmds.insert_len[d_idx]
        d_syms = cmds.dist_code[d_idx]
        dist_code_b, dist_code_n = encoding_table(dist_lengths)
        bits[d_pos] = dist_code_b[d_syms].astype(np.uint64)
        nbits[d_pos] = dist_code_n[d_syms]
        bits[d_pos + 1] = cmds.dist_extra[d_idx].astype(np.uint64)
        nbits[d_pos + 1] = cmds.dist_extra_bits[d_idx]

    writer.append_packed(*nb.pack_bits(bits, nbits))


def store_meta_block_auto(writer: BitWriter, full, start: int, mlen: int,
                          cmds: CommandArrays, dist_params, quality: int,
                          size_hint: int, mode: int, is_last: bool,
                          enable_splits: bool = True,
                          disable_literal_context_modeling: bool = False
                          ) -> bool:
    """Plan + serialize one optimized metablock through the native
    planner (store_metablock_native); returns False, having written
    nothing, where the planner refuses the block.

    The JAX package (brotli_tpu/encode/bitstream.py:404) falls back to
    its pure-Python planner (build_meta_block / store_meta_block), of
    which the native planner is the byte-identical copy, where the
    native store refuses a block for its buffer of 9 * mlen + 2^17
    bits.  That refusal is conservative (16 bits for each literal of
    the next insert), so a block of long inserts can be refused and
    still come out at 8 bits a byte or less, which every caller keeps.
    Here the native store then runs once more on a buffer for the worst
    case, which gives the pure-Python planner's bytes; the Python
    planner itself is not ported.  Where that store refuses too, the
    caller stores the block uncompressed."""
    from .metablock import choose_context_mode, choose_literal_context_map
    region = full[start:start + mlen]
    ctx_mode = choose_context_mode(region, quality, mode)
    if disable_literal_context_modeling:
        # one literal tree per block type: zero context LUTs collapse
        # every context to 0
        ctx_mode = 0
        nlc, smap = 1, np.zeros(64, dtype=np.int64)
        lut0 = lut1 = np.zeros(256, dtype=np.uint8)
    elif ctx_mode == C.CONTEXT_UTF8:
        nlc, smap = choose_literal_context_map(full, start, mlen, quality,
                                               size_hint)
        lut0, lut1 = C.CONTEXT_LUT0[ctx_mode], C.CONTEXT_LUT1[ctx_mode]
    else:
        nlc, smap = 1, np.zeros(64, dtype=np.int64)
        lut0, lut1 = C.CONTEXT_LUT0[ctx_mode], C.CONTEXT_LUT1[ctx_mode]
    args = (full, start, mlen, is_last, cmds, dist_params.npostfix,
            dist_params.ndirect, dist_params.alphabet_size, quality,
            ctx_mode, nlc, smap, lut0, lut1, enable_splits)
    res = nb.store_metablock(*args)
    if res is None:
        res = nb.store_metablock(*args, cap_bits=nb.worst_case_bits(mlen))
    if res is None:
        return False
    writer.append_packed(*res)
    return True


def store_meta_block_or_raw(writer: BitWriter, full, start: int, mlen: int,
                            cmds: CommandArrays, dist_params, quality: int,
                            size_hint: int, mode: int, is_last: bool,
                            disable_literal_context_modeling: bool = False
                            ) -> bool:
    """One metablock of resolved commands: store_meta_block_auto at
    quality >= 4, the trivial store below, kept at <= 8 * mlen + 40
    bits; else rolled back and stored uncompressed (reference
    encode.rs:2141-2163), the empty last metablock after it if is_last.
    Returns whether the block was kept compressed: only then does the
    decoder's distance cache take the commands' distances."""
    state = writer.save_state()
    before = writer.bit_length()
    if quality >= 4:
        kept = store_meta_block_auto(
            writer, full, start, mlen, cmds, dist_params, quality,
            size_hint, mode, is_last,
            disable_literal_context_modeling=disable_literal_context_modeling)
    else:
        store_meta_block_trivial(writer, full, start, mlen, is_last, cmds,
                                 dist_params)
        kept = True
    if kept and writer.bit_length() - before <= 8 * mlen + 40:
        return True
    writer.restore_state(state)
    store_uncompressed_meta_block(writer, full[start:start + mlen].tobytes())
    if is_last:
        write_empty_last_meta_block(writer)
    return False
