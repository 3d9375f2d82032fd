"""Command stream construction: distance codes, cache resolution, symbols.

A trimmed copy of brotli_tpu/encode/command.py.  A parsed metablock is
a struct of arrays of commands (insert_len, copy_len, distance); each
distance is resolved against the rolling 4-entry distance cache into a
short code, a direct code or a long code with extra bits (RFC 7932
section 4), and (insert code, copy code, dist0?) maps to the
704-symbol command alphabet.  The resolution is the native runtime's
where it is in use, else the pure-Python walk below (reference
ComputeDistanceCode, src/enc/command.rs:48-69, and the distance-cache
update of CreateBackwardReferences, backward_references/mod.rs:
2497-2503).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native_bridge as nb
from ..core import constants as C


@dataclass
class CommandArrays:
    """Fully resolved command stream for one metablock (struct of
    arrays).  copy_len is the WIRE value; copy_advance the bytes of
    input the command covers (they differ only for dictionary cutoff
    transforms)."""
    insert_len: np.ndarray       # int64[n]
    copy_len: np.ndarray         # int64[n], 0 only for a trailing insert
    distance: np.ndarray         # int64[n]
    dist_code: np.ndarray        # int64[n] distance symbol
    dist_extra: np.ndarray       # int64[n] extra-bit value
    dist_extra_bits: np.ndarray  # int64[n]
    cmd_sym: np.ndarray          # int64[n] command symbol (0..703)
    copy_advance: np.ndarray = None  # int64[n]; defaults to copy_len

    def __post_init__(self):
        if self.copy_advance is None:
            self.copy_advance = self.copy_len

    def __len__(self):
        return len(self.insert_len)


def compute_distance_code(distance: int, max_distance: int,
                          cache: list) -> int:
    """A distance's short code against the cache (reference
    ComputeDistanceCode, src/enc/command.rs:48-69), or -1 where it has
    none.  Distances beyond max_distance are dictionary references and
    take the long form."""
    if distance <= max_distance:
        if distance == cache[0]:
            return 0
        if distance == cache[1]:
            return 1
        if distance == cache[2]:
            return 2
        if distance == cache[3]:
            return 3
        d = distance - cache[0] + 3
        if 0 <= d <= 6 and d != 3:
            # cache[0] + delta: -1 -> 4, +1 -> 5, -2 -> 6, +2 -> 7,
            # -3 -> 8, +3 -> 9
            return (8, 6, 4, -1, 5, 7, 9)[d]
        d = distance - cache[1] + 3
        if 0 <= d <= 6 and d != 3:
            return (14, 12, 10, -1, 11, 13, 15)[d]
    return -1


def resolve_commands(insert_len, copy_len, distance, dist_params,
                     advance=None, initial_cache=None, pos_offset: int = 0,
                     window_size: int | None = None):
    """Resolve raw (insert, copy, distance) triples into wire commands;
    returns (CommandArrays, final distance cache).

    pos_offset: absolute output position at the start of these commands
    (short codes are valid only while distance <= max_distance);
    window_size: the stream window, max_distance = min(pos, window)."""
    insert_len = np.asarray(insert_len, dtype=np.int64)
    copy_len = np.asarray(copy_len, dtype=np.int64)
    distance = np.asarray(distance, dtype=np.int64)
    advance = copy_len if advance is None \
        else np.asarray(advance, dtype=np.int64)
    cache = list(initial_cache if initial_cache is not None
                 else C.INITIAL_DISTANCE_CACHE)
    wsz = window_size if window_size is not None else 1 << 62
    if nb.available():
        # position stepping uses the ADVANCE lengths; the command symbol
        # is computed from the wire lengths
        code, extra, bits, _, cmd_sym, cache = nb.resolve_distance_codes(
            insert_len, advance, distance, dist_params.npostfix,
            dist_params.ndirect, cache, pos_offset, wsz,
            wire_copy=copy_len)
        return CommandArrays(insert_len, copy_len, distance, code, extra,
                             bits, cmd_sym, advance), cache
    code, extra, bits, use_last, cache = _resolve_py(
        insert_len, advance, distance, dist_params.npostfix,
        dist_params.ndirect, cache, pos_offset, wsz)
    wire_copy = np.where(copy_len == 0, 4, copy_len)
    ins_code = C.get_insert_length_code(insert_len)
    copy_code = C.get_copy_length_code(wire_copy)
    # distance-code-0 cells exist only for ins_code < 8, copy_code < 16
    use_last &= (ins_code < 8) & (copy_code < 16)
    cmd_sym = C.combine_length_codes(ins_code, copy_code, use_last)
    return CommandArrays(insert_len, copy_len, distance, code, extra, bits,
                         cmd_sym, advance), cache


def _resolve_py(insert_len, advance, distance, npostfix, ndirect, cache,
                pos, window_size):
    """The sequential distance-cache walk: (dist_code, dist_extra,
    dist_extra_bits, use_last, final cache); `cache` is updated in
    place."""
    n = len(insert_len)
    dist_code = np.zeros(n, dtype=np.int64)
    dist_extra = np.zeros(n, dtype=np.int64)
    dist_extra_bits = np.zeros(n, dtype=np.int64)
    use_last = np.zeros(n, dtype=bool)
    il = insert_len.tolist()
    cl = advance.tolist()
    dl = distance.tolist()
    for i in range(n):
        pos += il[i]
        c = cl[i]
        d = dl[i]
        if c == 0:
            # a trailing insert-only command: wire copy length 4, no
            # distance
            use_last[i] = True
            continue
        max_distance = min(pos, window_size)
        sc = compute_distance_code(d, max_distance, cache)
        if sc == 0:
            use_last[i] = True
        elif sc > 0:
            dist_code[i] = sc
            cache.pop()
            cache.insert(0, d)
        else:
            if d <= ndirect:
                dist_code[i] = 15 + d  # direct code: 16 + d - 1
            else:
                sym, ex, nbits = C.encode_distance(d, npostfix, ndirect)
                dist_code[i] = int(sym)
                dist_extra[i] = int(ex)
                dist_extra_bits[i] = int(nbits)
            if d <= max_distance:  # dictionary references stay out
                cache.pop()
                cache.insert(0, d)
        pos += c
    return dist_code, dist_extra, dist_extra_bits, use_last, cache


def command_extra_bits(cmd: CommandArrays):
    """(insert_extra_val, insert_extra_bits, copy_extra_val,
    copy_extra_bits) per command, vectorized."""
    wire_copy = np.where(cmd.copy_len == 0, 4, cmd.copy_len)
    ins_code = C.get_insert_length_code(cmd.insert_len)
    copy_code = C.get_copy_length_code(wire_copy)
    ins_nbits = C.INSERT_EXTRA[ins_code]
    ins_val = cmd.insert_len - C.INSERT_BASE[ins_code]
    copy_nbits = C.COPY_EXTRA[copy_code]
    copy_val = wire_copy - C.COPY_BASE[copy_code]
    return ins_val, ins_nbits, copy_val, copy_nbits
