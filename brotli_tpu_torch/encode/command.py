"""Command stream construction: distance codes, cache resolution, symbols.

A trimmed copy of brotli_tpu/encode/command.py.  A parsed metablock is
a struct of arrays of commands (insert_len, copy_len, distance); each
distance is resolved against the rolling 4-entry distance cache into a
short code, a direct code or a long code with extra bits (RFC 7932
section 4), and (insert code, copy code, dist0?) maps to the
704-symbol command alphabet.  The resolution is the native runtime's:
the port has no pure-Python walk and raises when the runtime does not
build.
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
    # position stepping uses the ADVANCE lengths; the command symbol is
    # computed from the wire lengths
    code, extra, bits, _, cmd_sym, cache = nb.resolve_distance_codes(
        insert_len, advance, distance, dist_params.npostfix,
        dist_params.ndirect,
        list(initial_cache if initial_cache is not None
             else C.INITIAL_DISTANCE_CACHE),
        pos_offset, window_size if window_size is not None else 1 << 62,
        wire_copy=copy_len)
    return CommandArrays(insert_len, copy_len, distance, code, extra, bits,
                         cmd_sym, advance), cache


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
