"""RFC 7932 header readers and the host decode entry (trimmed).

A trimmed copy of brotli_tpu/decode/decoder.py: the error class, the
header field readers the batch decoder's walk uses (count codes, window
bits, context maps with RLE and inverse move-to-front; the walk takes
only metablocks of one block type per category, so it reads no
block-switch code), and `decompress`, which decodes one stream with the
native runtime.  The pure-Python Decoder class of the JAX package is
not ported: where the native runtime does not build, `decompress`
raises.
"""

from __future__ import annotations

import numpy as np

from ..core.bitio import NeedsMoreInput
from ..core.prefix import PrefixDecoder, read_prefix_code


class BrotliDecodeError(Exception):
    pass


def _read_count_code(reader) -> int:
    """NBLTYPES / NTREES variable-length count (RFC 9.2)."""
    if reader.read(1) == 0:
        return 1
    nbits = reader.read(3)
    return (1 << nbits) + 1 + reader.read(nbits)


def _read_window_bits(reader) -> int:
    """WBITS of a regular (not large-window) stream."""
    if reader.read(1) == 0:
        return 16
    n = reader.read(3)
    if n != 0:
        return 17 + n
    m = reader.read(3)
    if m == 0:
        return 17
    if m == 1:
        raise BrotliDecodeError("reserved WBITS pattern (large window?)")
    return 8 + m


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


def decompress(data) -> bytes:
    """One-shot decompress with the native decoder (trailing garbage
    after the last block is ignored).  Raises NeedsMoreInput for a
    truncated stream and BrotliDecodeError for a corrupt one."""
    from .. import native_bridge as nb
    try:
        return nb.decode(data)
    except ValueError as e:
        code = e.args[0] if e.args else -2
        if code == -1:
            raise NeedsMoreInput() from None
        raise BrotliDecodeError(
            f"corrupt stream (native code {code})") from None
