"""CompressMulti's range split and lossless merge.

Counterpart of brotli_tpu/parallel/multi.py's `_get_range` and
`_merge`: the reference (src/enc/threading/mod.rs:413-661) splits the
input into contiguous ranges, compresses each as a catable stream and
joins the outputs bit-exactly with BroCatli.  compress_mesh merges its
shards' streams with `_merge`.  `compress_multi` itself needs the host
encoder, which the port does not have yet (ROADMAP queue 1).
"""

from __future__ import annotations

from ..concat.brocatli import BroCatli, BroCatliResult


def _get_range(i: int, n_parts: int, n: int):
    return (i * n) // n_parts, ((i + 1) * n) // n_parts


def _merge(results) -> bytes:
    """One brotli stream from catable streams, in order (BroCatli);
    raises ValueError where BroCatli refuses a piece."""
    bc = BroCatli()
    out = bytearray()
    for piece in results:
        bc.new_brotli_file()
        res = bc.stream(piece, out)
        if res not in (BroCatliResult.NeedsMoreInput,
                       BroCatliResult.Success):
            raise ValueError(f"merge failed: {res.name}")
    res = bc.finish(out)
    if res != BroCatliResult.Success:
        raise ValueError(f"merge finish failed: {res.name}")
    return bytes(out)
