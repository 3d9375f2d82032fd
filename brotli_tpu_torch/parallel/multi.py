"""CompressMulti: parallel single-file compression with lossless merge.

The port's copy of brotli_tpu/parallel/multi.py, byte for byte the same
streams.  The reference (src/enc/threading/mod.rs:413-661) splits the
input into num_parts contiguous ranges; part 0 is compressed
appendable, every later part catable with the whole preceding prefix as
its LZ77 custom dictionary, so cross-shard matches are kept; the parts
are joined in order and merged bit-exactly by BroCatli.

Backends: "thread" (a thread a part; the native calls release the GIL),
"serial" (in the caller's thread), "process" (a process a part, from
the spawn start method: workers start from a fresh import and never
touch torch or CUDA) and "workpool" (the C API's persistent pthread
pool, BrotliEncoderCompressWorkPool; where the runtime is not in use
it falls back to threads, as in the JAX package).  favor_cpu_efficiency
builds one match table over the whole input that every part parses
against.  All of them run on the host, at every quality (10 and above
through the optimal parser).  compress_mesh merges its shards' streams
with `_merge`.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from .. import native_bridge as nb
from ..concat.brocatli import BroCatli, BroCatliResult
from ..core import constants as C
from ..core.bitio import BitWriter
from ..encode import bitstream as bs
from ..encode.command import resolve_commands
from ..encode.encoder import (POISONED_DISTANCE, _quality_knobs,
                              compress_with_params)
from ..encode.match import find_best_matches, greedy_parse
from ..encode.params import EncoderParams

MAX_THREADS = 16


def _get_range(i: int, n_parts: int, n: int):
    return (i * n) // n_parts, ((i + 1) * n) // n_parts


def compress_part(data: np.ndarray, i: int, n_parts: int,
                  params: EncoderParams) -> bytes:
    """Part i's stream (reference compress_part, threading/mod.rs:337):
    part 0 appendable, the others catable with the prefix before them
    as their custom dictionary."""
    n = len(data)
    lo, hi = _get_range(i, n_parts, n)
    part = data[lo:hi]
    if i == 0:
        p = EncoderParams(
            quality=params.quality, lgwin=params.lgwin, mode=params.mode,
            appendable=True).sanitize(len(part))
        return compress_with_params(part, p, pipeline=False)
    p = EncoderParams(
        quality=params.quality, lgwin=params.lgwin, mode=params.mode,
        catable=True).sanitize(len(part))
    prefix = data[:lo].tobytes()
    return compress_with_params(part, p, custom_dictionary=prefix,
                                pipeline=False)


def _compress_part_shared(raw, i, n_parts, params, best) -> bytes:
    """Part i's stream parsed against the match table `best` of the
    whole input (the favor_cpu_efficiency analog, reference
    threading/mod.rs:456-542: one hasher shared with every worker
    instead of each worker hashing its prefix again).  One metablock a
    part."""
    bl, bd, bsc, isd, bw = best
    n = len(raw)
    lo, hi = _get_range(i, n_parts, n)
    w = BitWriter()
    p = EncoderParams(
        quality=params.quality, lgwin=params.lgwin, mode=params.mode,
        appendable=(i == 0), catable=(i > 0)).sanitize(hi - lo)

    bs.write_stream_header(w, p.lgwin, p.large_window)
    start = lo
    cache = list(C.INITIAL_DISTANCE_CACHE)
    if i > 0:
        cache = [POISONED_DISTANCE] * 4
        k = min(2, hi - lo)
        bs.store_uncompressed_meta_block(w, raw[lo:lo + k].tobytes())
        start = lo + k
    if start < hi:
        region = raw[:hi]
        segs = greedy_parse(region, bl[:hi], bd[:hi], bsc[:hi], [hi],
                            dict_len=0, pos0=start,
                            initial_cache=tuple(cache),
                            best_isdict=isd[:hi], window_size=p.window_size,
                            best_wire=bw[:hi])
        ins, cps, dst, adv = segs[0]
        cmds, _ = resolve_commands(ins, cps, dst, p.dist, advance=adv,
                                   initial_cache=cache, pos_offset=start,
                                   window_size=p.window_size)
        bs.store_meta_block_or_raw(w, region, start, hi - start, cmds,
                                   p.dist, p.quality, hi - start, p.mode,
                                   False)
    bs.write_empty_last_meta_block(w)  # '11' trailer, stripped on merge
    return w.getvalue()


def _join_all(futures) -> list:
    """Every future's result in order; joins all of them even when one
    fails, then raises the first error (reference threading/mod.rs:506)."""
    results, first_err = [], None
    for f in futures:
        try:
            results.append(f.result())
        except Exception as e:  # noqa: BLE001 -- re-raised below
            results.append(None)
            if first_err is None:
                first_err = e
    if first_err is not None:
        raise first_err
    return results


def compress_multi(data, num_parts: int, quality: int = 9,
                   lgwin: int = 22, mode: int = 0,
                   backend: str = "thread",
                   favor_cpu_efficiency: bool = False) -> bytes:
    """Parallel compress + lossless merge (reference CompressMulti,
    threading/mod.rs:413).  num_parts is capped at MAX_THREADS and at
    one part a 4096 bytes of input.

    favor_cpu_efficiency: at q2-q9, one match table over the whole input
    that every part parses against (on the thread or serial backend);
    otherwise each part hashes its own prefix."""
    raw = np.frombuffer(bytes(data), dtype=np.uint8)
    num_parts = max(1, min(num_parts, MAX_THREADS))
    if len(raw) < num_parts * 4096:
        num_parts = max(1, len(raw) // 4096)
    params = EncoderParams(quality=quality, lgwin=lgwin,
                           mode=mode).sanitize(None)

    if num_parts == 1:
        p = EncoderParams(quality=quality, lgwin=lgwin,
                          mode=mode).sanitize(len(raw))
        return compress_with_params(raw, p)

    if backend == "workpool" and not favor_cpu_efficiency:
        if nb.available():
            return nb.work_pool_compress(raw.tobytes(), num_parts, quality,
                                         lgwin, mode)
        backend = "thread"  # the pool is the runtime's

    if favor_cpu_efficiency and 2 <= params.quality <= 9:
        knobs = _quality_knobs(params)
        # shards > 0 are catable: no static dictionary (SanitizeParams)
        best = find_best_matches(
            raw, params.window_size, dict_len=0,
            literal_byte_score=params.literal_byte_score,
            use_dictionary=False, **knobs)
        if backend == "thread":
            with ThreadPoolExecutor(max_workers=num_parts) as pool:
                results = _join_all([
                    pool.submit(_compress_part_shared, raw, i, num_parts,
                                params, best) for i in range(num_parts)])
        else:
            results = [_compress_part_shared(raw, i, num_parts, params,
                                             best)
                       for i in range(num_parts)]
        return _merge(results)

    if backend == "thread":
        with ThreadPoolExecutor(max_workers=num_parts) as pool:
            results = _join_all([
                pool.submit(compress_part, raw, i, num_parts, params)
                for i in range(num_parts)])
    elif backend == "process":
        # real parallelism for the Python glue between the native calls;
        # the input is shipped to each worker as bytes
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=num_parts,
                                 mp_context=ctx) as pool:
            whole = raw.tobytes()
            results = _join_all([
                pool.submit(_compress_part_bytes, whole, i, num_parts,
                            quality, lgwin, mode)
                for i in range(num_parts)])
    else:
        results = [compress_part(raw, i, num_parts, params)
                   for i in range(num_parts)]
    return _merge(results)


def _compress_part_bytes(data: bytes, i: int, n_parts: int,
                         quality: int, lgwin: int, mode: int) -> bytes:
    """Picklable worker of the process backend."""
    raw = np.frombuffer(data, dtype=np.uint8)
    params = EncoderParams(quality=quality, lgwin=lgwin,
                           mode=mode).sanitize(None)
    return compress_part(raw, i, n_parts, params)


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
