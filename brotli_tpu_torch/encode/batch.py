"""Batched encode for the serving path: many independent payloads
compressed concurrently.

The port's copy of brotli_tpu/encode/batch.py: one thread per payload
(the native parse and store calls release the GIL), results in input
order, every worker joined before the first error is raised."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from .encoder import compress


def compress_batch(payloads, threads: int = 8, **params):
    """Compress a list of independent payloads concurrently.

    Returns a list of compressed streams in input order; `params` are
    forwarded to compress() (quality, lgwin, ...).  Raises the first
    error after every worker drains."""
    payloads = list(payloads)
    if threads <= 1 or len(payloads) <= 1:
        return [compress(p, **params) for p in payloads]
    results = [None] * len(payloads)
    first_err = None
    with ThreadPoolExecutor(max_workers=threads) as pool:
        futs = {pool.submit(compress, p, **params): i
                for i, p in enumerate(payloads)}
        for f, i in futs.items():
            try:
                results[i] = f.result()
            except Exception as e:  # noqa: BLE001 -- re-raised below
                if first_err is None:
                    first_err = e
    if first_err is not None:
        raise first_err
    return results
