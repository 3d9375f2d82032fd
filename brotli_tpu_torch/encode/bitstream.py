"""Metablock serialization on the host.

A copy of brotli_tpu/encode/bitstream.py: the window header, MLEN, the
empty last, padding and metadata metablocks, the magic-number header,
the uncompressed metablock (the store for spans whose compressed form
would be larger), context maps (move-to-front and zero-run coding), the
trivial metablock (one prefix code per category), the optimized
metablock of a MetaBlockPlan (block-switch codes, context maps, trees
per literal context, per command block and per distance context;
store_meta_block), and store_meta_block_auto, which runs the native
planner and falls back to the pure-Python one on the blocks the native
store refuses (and on every block where the runtime is not in use).
The symbol stream is built as (bits, nbits) item arrays in stream
order, block switches inserted where they fire, and packed by
pack_bits: the native packer, or its numpy form where the runtime is
not in use.
"""

from __future__ import annotations

import numpy as np

from .. import native_bridge as nb
from ..core import constants as C
from ..core.bitio import BitWriter
from ..core.huffman import build_huffman_lengths
from ..core.prefix import encoding_table, write_prefix_code
from .command import CommandArrays, command_extra_bits


def pack_bits(bits: np.ndarray, nbits: np.ndarray):
    """Pack (bits[i], nbits[i]) items LSB-first into uint64 words;
    returns (words, total_bits).  nbits may be 0 (the item is skipped);
    each item fits 32 bits, so a shifted value spans at most 2 words.
    The native packer where the runtime is in use, else this numpy
    scatter (ops/bitpack.pack_bits_u32 is its device form)."""
    if nb.available():
        return nb.pack_bits(bits, nbits)
    bits = np.asarray(bits, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    total = int(nbits.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint64), 0
    pos = np.zeros(len(nbits), dtype=np.int64)
    np.cumsum(nbits[:-1], out=pos[1:])
    word = pos >> 6
    shift = (pos & 63).astype(np.uint64)
    # +2: a trailing zero-bit item (a one-symbol code) sits at pos ==
    # total and still scatters into word + 1
    words = np.zeros(total // 64 + 2, dtype=np.uint64)
    lo = bits << shift
    hi = np.where(shift > 0, bits >> (np.uint64(64) - shift), 0).astype(
        np.uint64)
    np.bitwise_or.at(words, word, lo)
    np.bitwise_or.at(words, word + 1, hi)
    return words, total


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


def write_count_code(writer: BitWriter, v: int):
    """NBLTYPES / NTREES variable-length count (RFC 9.2)."""
    assert 1 <= v <= 256
    if v == 1:
        writer.write(0, 1)
        return
    writer.write(1, 1)
    nbits = (v - 1).bit_length() - 1
    writer.write(nbits, 3)
    writer.write(v - 1 - (1 << nbits), nbits)


def mtf_encode(values: np.ndarray) -> np.ndarray:
    """Forward move-to-front (decoder applies the inverse, RFC 7.3)."""
    mtf = list(range(256))
    out = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(np.asarray(values).tolist()):
        j = mtf.index(v)
        out[i] = j
        if j:
            del mtf[j]
            mtf.insert(0, v)
    return out


def write_context_map(writer: BitWriter, cmap: np.ndarray, ntrees: int):
    """Serialize a context map with MTF + zero-RLE (RFC 7.3; reference
    EncodeContextMap, brotli_bit_stream.rs:1783)."""
    vals = mtf_encode(cmap)
    # tokenize: zero runs -> (sym s, extra, s bits); values -> rlemax + v
    runs = []
    i = 0
    n = len(vals)
    max_run_bits = 0
    while i < n:
        if vals[i] == 0:
            j = i
            while j < n and vals[j] == 0:
                j += 1
            r = j - i
            runs.append((0, r))
            if r >= 2:
                max_run_bits = max(max_run_bits, int(np.log2(r)))
            i = j
        else:
            runs.append((int(vals[i]), 1))
            i += 1
    rlemax = min(16, max_run_bits)
    tokens = []  # (symbol, extra_val, extra_bits)
    for v, r in runs:
        if v != 0:
            tokens.append((rlemax + v, 0, 0))
            continue
        while r > 0:
            if r == 1:
                tokens.append((0, 0, 0))
                r = 0
            else:
                s = min(rlemax, int(np.log2(r)))
                if s == 0:
                    tokens.append((0, 0, 0))
                    r -= 1
                    continue
                take = min(r, (1 << s) + ((1 << s) - 1))
                # ensure remainder is representable (avoid leaving r == 0
                # mid-run is fine; any r >= 1 is representable)
                extra = take - (1 << s)
                tokens.append((s, extra, s))
                r -= take
    hist = np.zeros(ntrees + rlemax, dtype=np.int64)
    for sym, _, _ in tokens:
        hist[sym] += 1
    lengths = build_huffman_lengths(hist)
    if rlemax:
        writer.write(1, 1)
        writer.write(rlemax - 1, 4)
    else:
        writer.write(0, 1)
    write_prefix_code(writer, lengths)
    codes, emit_lens = encoding_table(lengths)
    for sym, extra, ebits in tokens:
        writer.write(int(codes[sym]), int(emit_lens[sym]))
        if ebits:
            writer.write(extra, ebits)
    writer.write(1, 1)  # IMTF


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
    emit_command_stream(writer, cmds, literals,
                        [lit_lengths], None,
                        [cmd_lengths],
                        [dist_lengths], None)


# ---------------------------------------------------------------------------
# Full metablock (block types + context maps)
# ---------------------------------------------------------------------------


def _write_block_switch_header(writer: BitWriter, plan, type_lengths,
                               len_lengths):
    """Per-category header: type code, length code, first block length."""
    write_prefix_code(writer, type_lengths)
    write_prefix_code(writer, len_lengths)
    len_codes, len_emit = encoding_table(len_lengths)
    flc = plan["first_len_code"]
    writer.write(int(len_codes[flc]), int(len_emit[flc]))
    writer.write(int(plan["first_len"] - C.BLOCK_LEN_BASE[flc]),
                 int(C.BLOCK_LEN_EXTRA[flc]))


def store_meta_block(writer: BitWriter, plan, is_last: bool):
    """Serialize a fully-optimized metablock (reference store_meta_block,
    brotli_bit_stream.rs:2035): block-switch codes, context maps, multiple
    prefix codes per category, vectorized emission with switch insertion."""
    writer.write(1 if is_last else 0, 1)
    if is_last:
        writer.write(0, 1)
    write_mlen(writer, plan.mlen)
    if not is_last:
        writer.write(0, 1)  # ISUNCOMPRESSED = 0

    switch_headers = []
    for split_plan, nt in ((plan.lit_switch, plan.lit_ntypes),
                           (plan.cmd_switch, plan.cmd_ntypes),
                           (plan.dist_switch, plan.dist_ntypes)):
        write_count_code(writer, nt)
        if nt >= 2:
            tl = build_huffman_lengths(_safe_hist(split_plan["type_hist"]))
            ll = build_huffman_lengths(_safe_hist(split_plan["len_hist"]))
            _write_block_switch_header(writer, split_plan, tl, ll)
            switch_headers.append((tl, ll))
        else:
            switch_headers.append((None, None))

    writer.write(plan.dist_params.npostfix, 2)
    writer.write(plan.dist_params.ndirect >> plan.dist_params.npostfix, 4)
    for _ in range(plan.lit_ntypes):
        writer.write(plan.context_mode, 2)

    write_count_code(writer, plan.ntrees_l)
    if plan.ntrees_l >= 2:
        write_context_map(writer, plan.cmap_l, plan.ntrees_l)
    write_count_code(writer, plan.ntrees_d)
    if plan.ntrees_d >= 2:
        write_context_map(writer, plan.cmap_d, plan.ntrees_d)

    for lengths in plan.lit_lengths:
        write_prefix_code(writer, lengths)
    for lengths in plan.cmd_lengths:
        write_prefix_code(writer, lengths)
    for lengths in plan.dist_lengths:
        write_prefix_code(writer, lengths)

    switches = _build_switch_items(plan, switch_headers)
    emit_command_stream(writer, plan.cmds, plan.literals,
                        plan.lit_lengths, plan.lit_tree,
                        plan.cmd_lengths,
                        plan.dist_lengths, plan.dist_tree,
                        cmd_block=plan.cmd_tree, switches=switches)




def store_meta_block_auto(writer: BitWriter, full, start: int, mlen: int,
                          cmds: CommandArrays, dist_params, quality: int,
                          size_hint: int, mode: int, is_last: bool,
                          enable_splits: bool = True,
                          disable_literal_context_modeling: bool = False):
    """Plan + serialize one optimized metablock through the native
    planner (store_metablock_native); where the native store refuses the
    block for its buffer of 9 * mlen + 2^17 bits (its refusal test
    charges 16 bits for each literal of the next insert), the
    pure-Python planner and store (metablock.build_meta_block +
    store_meta_block) plan and write it instead, as the JAX package
    does; where the runtime is not in use, they plan and write every
    block."""
    from .metablock import choose_literal_context
    if not nb.available():
        _store_planned(writer, full, start, mlen, cmds, dist_params,
                       quality, size_hint, mode, is_last, enable_splits,
                       disable_literal_context_modeling)
        return
    if disable_literal_context_modeling:
        # one literal tree per block type: zero context LUTs collapse
        # every context to 0
        ctx_mode, nlc, smap = 0, 1, np.zeros(64, dtype=np.int64)
        lut0 = lut1 = np.zeros(256, dtype=np.uint8)
    else:
        ctx_mode, nlc, smap = choose_literal_context(
            full, start, mlen, quality, mode, size_hint)
        lut0, lut1 = C.CONTEXT_LUT0[ctx_mode], C.CONTEXT_LUT1[ctx_mode]
    res = nb.store_metablock(
        full, start, mlen, is_last, cmds, dist_params.npostfix,
        dist_params.ndirect, dist_params.alphabet_size, quality,
        ctx_mode, nlc, smap, lut0, lut1, enable_splits)
    if res is not None:
        writer.append_packed(*res)
        return
    _store_planned(writer, full, start, mlen, cmds, dist_params, quality,
                   size_hint, mode, is_last, enable_splits,
                   disable_literal_context_modeling)


def _store_planned(writer, full, start, mlen, cmds, dist_params, quality,
                   size_hint, mode, is_last, enable_splits,
                   disable_literal_context_modeling):
    """One metablock through the pure-Python planner and store."""
    from .metablock import build_meta_block
    plan = build_meta_block(full, start, mlen, cmds, dist_params,
                            quality, size_hint, mode=mode,
                            enable_splits=enable_splits,
                            num_lit_ctx=1 if
                            disable_literal_context_modeling else None,
                            lit_static_map=np.zeros(64, np.int64) if
                            disable_literal_context_modeling else None)
    store_meta_block(writer, plan, is_last)


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
        store_meta_block_auto(
            writer, full, start, mlen, cmds, dist_params, quality,
            size_hint, mode, is_last,
            disable_literal_context_modeling=disable_literal_context_modeling)
    else:
        store_meta_block_trivial(writer, full, start, mlen, is_last, cmds,
                                 dist_params)
    if not _expands(writer.bit_length() - before, mlen):
        return True
    writer.restore_state(state)
    store_raw(writer, full[start:start + mlen], is_last)
    return False


def _expands(nbits: int, mlen: int) -> bool:
    """The expansion rule (reference encode.rs:2141-2163): a compressed
    metablock of more than 8 * mlen + 40 bits is stored uncompressed."""
    return nbits > 8 * mlen + 40


def append_native(writer: BitWriter, res, mlen: int):
    """The native store's metablock res = (words, nbits, cache)
    appended where the store took it (not None) and it does not expand.
    Returns the distance cache after it, or None: the caller then stores
    the block uncompressed (store_raw), which leaves the decoder's cache
    as it was."""
    if res is None or _expands(res[1], mlen):
        return None
    writer.append_packed(res[0], res[1])
    return res[2]


def store_raw(writer: BitWriter, data: np.ndarray, is_last: bool):
    """data as an uncompressed metablock, the empty last metablock
    after it if is_last."""
    store_uncompressed_meta_block(writer, data.tobytes())
    if is_last:
        write_empty_last_meta_block(writer)


def _build_switch_items(plan, switch_headers):
    """Per-category block-switch wire items: (at_symbol_index,
    3 x (bits, nbits)) keyed by category."""
    out = {}
    for cat, split_plan, (tl, ll) in zip(
            ("lit", "cmd", "dist"),
            (plan.lit_switch, plan.cmd_switch, plan.dist_switch),
            switch_headers):
        if tl is None or split_plan is None \
                or len(split_plan["switch_at"]) == 0:
            continue
        tcodes, temit = encoding_table(tl)
        lcodes, lemit = encoding_table(ll)
        at = split_plan["switch_at"]
        m = len(at)
        bits = np.zeros((m, 3), dtype=np.uint64)
        nbits = np.zeros((m, 3), dtype=np.int64)
        for j in range(m):
            ts = split_plan["type_syms"][j]
            lc = split_plan["len_codes"][j]
            ev, eb = split_plan["len_extra"][j]
            bits[j] = (int(tcodes[ts]), int(lcodes[lc]), ev)
            nbits[j] = (int(temit[ts]), int(lemit[lc]), eb)
        out[cat] = (np.asarray(at, dtype=np.int64), bits, nbits)
    return out


# ---------------------------------------------------------------------------
# Vectorized command-stream emission
# ---------------------------------------------------------------------------


def emit_command_stream(writer: BitWriter, cmds: CommandArrays,
                        literals: np.ndarray,
                        lit_codes_list, lit_tree_of_literal,
                        cmd_codes_list,
                        dist_codes_list, dist_tree_of_dist,
                        cmd_block=None, switches=None):
    """Emit the interleaved symbol stream of one metablock, vectorized.

    lit_codes_list / cmd_codes_list / dist_codes_list: per-tree code-length
    arrays.  lit_tree_of_literal (int[n_lit]) selects the tree per literal
    (None = tree 0); dist_tree_of_dist likewise per distance symbol.
    cmd_block (int[n_cmd]) selects the command tree (None = tree 0).
    switches: dict of category -> (at_symbol_index, bits[m,3], nbits[m,3])
    block-switch items inserted before the at-index-th symbol of that
    category (RFC 6: switches fire when the category counter exhausts).
    """
    n = len(cmds)
    ins_val, ins_nb, copy_val, copy_nb = command_extra_bits(cmds)
    dist_mask = (cmds.copy_len > 0) & ~C.CMD_IMPLICIT_DIST0[cmds.cmd_sym]

    # Per-command item counts: cmd, ins_extra, copy_extra, literals, [dist+extra]
    items_per_cmd = 3 + cmds.insert_len + 2 * dist_mask
    offs = np.zeros(n, dtype=np.int64)
    np.cumsum(items_per_cmd[:-1], out=offs[1:])
    total_items = int(items_per_cmd.sum())

    bits = np.zeros(total_items, dtype=np.uint64)
    nbits = np.zeros(total_items, dtype=np.int64)

    # command symbols
    cmd_tree = (np.zeros(n, dtype=np.int64) if cmd_block is None
                else np.asarray(cmd_block))
    cmd_code_b = np.stack([encoding_table(l)[0] for l in cmd_codes_list])
    cmd_code_n = np.stack([encoding_table(l)[1] for l in cmd_codes_list])
    bits[offs] = cmd_code_b[cmd_tree, cmds.cmd_sym].astype(np.uint64)
    nbits[offs] = cmd_code_n[cmd_tree, cmds.cmd_sym]
    # insert/copy extra bits
    bits[offs + 1] = ins_val.astype(np.uint64)
    nbits[offs + 1] = ins_nb
    bits[offs + 2] = copy_val.astype(np.uint64)
    nbits[offs + 2] = copy_nb

    # literals
    n_lit = len(literals)
    lit_pos = np.zeros(0, dtype=np.int64)
    if n_lit:
        owner = np.repeat(np.arange(n), cmds.insert_len)
        run_off = np.arange(n_lit) - np.repeat(
            np.concatenate([[0], np.cumsum(cmds.insert_len)[:-1]]),
            cmds.insert_len)
        lit_pos = offs[owner] + 3 + run_off
        lit_tree = (np.zeros(n_lit, dtype=np.int64)
                    if lit_tree_of_literal is None
                    else np.asarray(lit_tree_of_literal))
        lit_code_b = np.stack([encoding_table(l)[0] for l in lit_codes_list])
        lit_code_n = np.stack([encoding_table(l)[1] for l in lit_codes_list])
        bits[lit_pos] = lit_code_b[lit_tree, literals].astype(np.uint64)
        nbits[lit_pos] = lit_code_n[lit_tree, literals]

    # distance symbols + extra bits
    d_idx = np.nonzero(dist_mask)[0]
    d_pos = np.zeros(0, dtype=np.int64)
    if len(d_idx):
        d_pos = offs[d_idx] + 3 + cmds.insert_len[d_idx]
        d_syms = cmds.dist_code[d_idx]
        d_tree = (np.zeros(len(d_idx), dtype=np.int64)
                  if dist_tree_of_dist is None
                  else np.asarray(dist_tree_of_dist))
        dist_code_b = np.stack([encoding_table(l)[0] for l in dist_codes_list])
        dist_code_n = np.stack([encoding_table(l)[1] for l in dist_codes_list])
        bits[d_pos] = dist_code_b[d_tree, d_syms].astype(np.uint64)
        nbits[d_pos] = dist_code_n[d_tree, d_syms]
        bits[d_pos + 1] = cmds.dist_extra[d_idx].astype(np.uint64)
        nbits[d_pos + 1] = cmds.dist_extra_bits[d_idx]

    if switches:
        # Map per-category symbol indices to item-stream positions and
        # insert the 3-item switch groups before them.
        ins_at, ins_bits, ins_nbits = [], [], []
        pos_of = {"lit": lit_pos, "cmd": offs, "dist": d_pos}
        for cat, (at, sb, sn) in switches.items():
            items = pos_of[cat][at]
            ins_at.append(np.repeat(items, 3))
            ins_bits.append(sb.reshape(-1))
            ins_nbits.append(sn.reshape(-1))
        ins_at = np.concatenate(ins_at)
        ins_bits = np.concatenate(ins_bits)
        ins_nbits = np.concatenate(ins_nbits)
        order = np.argsort(ins_at, kind="stable")
        bits = np.insert(bits, ins_at[order], ins_bits[order])
        nbits = np.insert(nbits, ins_at[order], ins_nbits[order])

    writer.append_packed(*pack_bits(bits, nbits))
