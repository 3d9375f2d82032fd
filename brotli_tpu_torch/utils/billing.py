"""Stream bit accounting: decode a brotli stream and report where the
bits go (the analog of the reference's `billing` feature,
src/enc/brotli_bit_stream.rs:194-218).

A copy of brotli_tpu/utils/billing.py on the port's pure-Python
decoder (decode/decoder.py) and its BitReader: read, skip and
read_bytes are billed to the current section (headers, block switches,
context maps, prefix-code descriptions, command / literal / distance
symbols, extra bits), and compare() prints two streams side by side.
"""

from __future__ import annotations

from collections import Counter

from ..core import constants as C
from ..core.bitio import BitReader
from ..core.prefix import PrefixDecoder, read_prefix_code
from ..decode import decoder as D


class BillingReader(BitReader):
    """BitReader that attributes consumed bits to a current section."""

    def __init__(self, data):
        super().__init__(data)
        self.bill = Counter()
        self.section = "header"

    def read(self, nbits):
        self.bill[self.section] += nbits
        return super().read(nbits)

    def skip(self, nbits):
        self.bill[self.section] += nbits
        return super().skip(nbits)

    def read_bytes(self, n):
        self.bill[self.section] += 8 * n
        return super().read_bytes(n)


def account(stream: bytes, custom_dictionary: bytes = b"",
            large_window: bool = False) -> dict:
    """Decode `stream`, returning {'bits': Counter, 'stats': Counter}."""
    reader = BillingReader(stream)
    stats = Counter()
    trace = []  # (tree, dcode, distance, copy_len) per explicit distance
    commands = []  # (insert_len, wire_copy_len, distance, advance)

    class AccountingDecoder(D.Decoder):
        def _decode_compressed_metablock(self, reader, out, mlen,
                                         window_size, dist_cache,
                                         dict_bytes, static_dict):
            stats["metablocks"] += 1
            blocks = {c: D._BlockCategory() for c in "LID"}
            reader.section = "block_headers"
            for c in "LID":
                blocks[c].read_header(reader)
                stats[f"nbltypes_{c}"] = max(stats[f"nbltypes_{c}"],
                                             blocks[c].num_types)
            reader.section = "dist_params"
            npostfix = reader.read(2)
            ndirect = reader.read(4) << npostfix
            reader.section = "context"
            context_modes = [reader.read(2)
                             for _ in range(blocks["L"].num_types)]
            ntrees_l = D._read_count_code(reader)
            cmap_l = D._read_context_map(
                reader, 64 * blocks["L"].num_types, ntrees_l)
            ntrees_d = D._read_count_code(reader)
            cmap_d = D._read_context_map(
                reader, 4 * blocks["D"].num_types, ntrees_d)
            stats["ntrees_l"] += ntrees_l
            stats["ntrees_d"] += ntrees_d
            max_distbits = 62 if self.large_window else 24
            dist_alpha = C.distance_alphabet_size(npostfix, ndirect,
                                                  max_distbits)
            reader.section = "tree_descriptions"
            lit_decs = [PrefixDecoder(read_prefix_code(reader, 256))
                        for _ in range(ntrees_l)]
            cmd_decs = [PrefixDecoder(read_prefix_code(reader, 704))
                        for _ in range(blocks["I"].num_types)]
            dist_decs = [PrefixDecoder(read_prefix_code(reader, dist_alpha))
                         for _ in range(ntrees_d)]

            L, I, Dd = blocks["L"], blocks["I"], blocks["D"]
            lut0, lut1 = C.CONTEXT_LUT0, C.CONTEXT_LUT1
            dlen = len(dict_bytes)

            def prev_byte(k):
                if len(out) >= k:
                    return out[-k]
                i = dlen - (k - len(out))
                return dict_bytes[i] if i >= 0 else 0

            p1, p2 = prev_byte(1), prev_byte(2)

            def tick(cat, key):
                reader.section = "block_switch"
                cat.tick(reader)
                reader.section = key

            while mlen > 0:
                tick(I, "cmd_syms")
                cmd_sym = cmd_decs[I.cur].decode(reader)
                stats["commands"] += 1
                ins_code = int(C.CMD_TO_INSERT_CODE[cmd_sym])
                copy_code = int(C.CMD_TO_COPY_CODE[cmd_sym])
                reader.section = "insert_copy_extra"
                ins_len = int(C.INSERT_BASE[ins_code]) + reader.read(
                    int(C.INSERT_EXTRA[ins_code]))
                copy_len = int(C.COPY_BASE[copy_code]) + reader.read(
                    int(C.COPY_EXTRA[copy_code]))
                for _ in range(ins_len):
                    tick(L, "lit_syms")
                    mode = context_modes[L.cur]
                    ctx = int(lut0[mode][p1]) | int(lut1[mode][p2])
                    tree = int(cmap_l[(L.cur << 6) | ctx])
                    lit = lit_decs[tree].decode(reader)
                    out.append(lit)
                    stats["literals"] += 1
                    p2, p1 = p1, lit
                mlen -= ins_len
                if mlen == 0:
                    commands.append((ins_len, 0, 0, 0))
                    break
                pos_total = len(out) + dlen
                max_distance = min(pos_total, window_size)
                if C.CMD_IMPLICIT_DIST0[cmd_sym]:
                    distance = dist_cache[0]
                    dcode = 0
                    stats["dist_implicit0"] += 1
                else:
                    tick(Dd, "dist_syms")
                    dctx = int(C.distance_context_from_copy_len(copy_len))
                    tree = int(cmap_d[(Dd.cur << 2) | dctx])
                    dcode = dist_decs[tree].decode(reader)
                    if dcode == 0:
                        stats["dist_code0"] += 1
                    elif dcode < 16:
                        stats["dist_short"] += 1
                    else:
                        stats["dist_long"] += 1
                    if dcode < 16:
                        idx = int(C.DISTANCE_SHORT_CODE_INDEX[dcode])
                        delta = int(C.DISTANCE_SHORT_CODE_DELTA[dcode])
                        distance = dist_cache[idx] + delta
                    elif dcode < 16 + ndirect:
                        distance = dcode - 16 + 1
                    else:
                        reader.section = "dist_extra"
                        nbits = int(C.num_distance_extra_bits(
                            dcode, npostfix, ndirect))
                        extra = reader.read(nbits)
                        distance = int(C.decode_distance(
                            dcode, npostfix, ndirect, extra))
                        reader.section = "dist_syms"
                stats[f"copy_len_{min(copy_len, 10)}"] += 1
                if not C.CMD_IMPLICIT_DIST0[cmd_sym]:
                    trace.append((tree, dcode, distance, copy_len))
                if distance > max_distance:
                    word = static_dict.resolve(
                        copy_len, distance - max_distance - 1)
                    stats["dict_refs"] += 1
                    trace.append(("dict", copy_len,
                                  distance - max_distance - 1, len(word)))
                    commands.append((ins_len, copy_len, distance,
                                     len(word)))
                    out += word
                    mlen -= len(word)
                else:
                    D._backward_copy(out, distance, copy_len, dict_bytes)
                    commands.append((ins_len, copy_len, distance,
                                     copy_len))
                    mlen -= copy_len
                    if dcode != 0:
                        dist_cache.pop()
                        dist_cache.insert(0, distance)
                p1, p2 = prev_byte(1), prev_byte(2)
            reader.section = "header"

    dec = AccountingDecoder(custom_dictionary, large_window)
    out = dec.decompress_reader(reader)
    return {"bits": reader.bill, "stats": stats, "output_len": len(out),
            "dist_trace": trace, "commands": commands}


def compare(a: bytes, b: bytes, label_a="ours", label_b="theirs"):
    """Print a side-by-side billing comparison of two streams."""
    ra, rb = account(a), account(b)
    keys = sorted(set(ra["bits"]) | set(rb["bits"]))
    print(f'{"section":22s} {label_a:>12s} {label_b:>12s} {"delta":>10s}')
    for k in keys:
        va, vb = ra["bits"].get(k, 0), rb["bits"].get(k, 0)
        print(f"{k:22s} {va:12d} {vb:12d} {va - vb:+10d}")
    ta, tb = sum(ra["bits"].values()), sum(rb["bits"].values())
    print(f'{"TOTAL bits":22s} {ta:12d} {tb:12d} {ta - tb:+10d}')
    keys = sorted(set(ra["stats"]) | set(rb["stats"]))
    for k in keys:
        va, vb = ra["stats"].get(k, 0), rb["stats"].get(k, 0)
        print(f"{k:22s} {va:12d} {vb:12d} {va - vb:+10d}")
    return ra, rb
