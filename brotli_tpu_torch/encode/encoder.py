"""The host encoder: one-shot compress at qualities 0-11, quality
dispatch and stream assembly.

The port's copy of brotli_tpu/encode/encoder.py, byte for byte the same
streams.  compress() has the reference's stream-shaping flags (catable,
appendable, bare, byte_align, magic_number), custom LZ77 dictionaries,
the per-metablock uncompressed fallback and the whole-stream
uncompressed fallback (reference encoder_compress, encode.rs:1436).
It runs on the host alone, through the port's native runtime
(native_bridge.py), and touches no tensor: the device paths are
compress_gpu, compress_fast and compress_mesh.

Tiers: q0/q1 run the fragment parse (one direct-mapped table, greedy,
no dictionary) and q2/q3 the basic-tier parse session, each as one
native call for the whole stream where nothing else is asked for;
q4-q9 run the native search + parse one metablock at a time (a parse
session, prefetched one metablock ahead, or two sessions on inputs of
2 MiB and more) into one fused resolve + plan + serialize call per
metablock.  A metablock_callback or a stream_offset selects the
unfused loop, which resolves the commands in Python first.  Quality 10
and above runs the optimal parser (encode/zopfli.py) one metablock at a
time, its candidates collected one metablock ahead, into the unfused
loop, which searches each metablock's NPOSTFIX/NDIRECT there: q9_5
(quality 10, or 12 for the deeper -q9.5y tier) and plain q10 parse with
one cost-model iteration, q10_deep with two, q11 with up to Q11_ITERS.
Below quality 10, q9_5 and q10_deep change nothing.

Where the runtime is not in use (native_bridge.available() false),
every tier below 10 runs the match finder and the greedy walk over the
whole input (the numpy and Python forms of encode/match.py; no
fragment tier, no session) into the unfused loop, as the JAX package
does; quality 10 and above runs the optimal parser's pure-Python
routes.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native_bridge as nb
from ..core import constants as C
from ..core.bitio import BitWriter
from ..utils.ir import ir_from_commands
from . import bitstream as bs
from .command import resolve_commands
from .match import find_best_matches, greedy_parse
from .metablock import choose_distance_params, choose_literal_context
from .params import EncoderParams
from .zopfli import zopfli_collect, zopfli_segment

# Catable streams poison the initial distance cache so no command can rely
# on the RFC's initial {4, 11, 15, 16} values, which would differ when the
# stream is appended after another (reference encode.rs:693-703).
POISONED_DISTANCE = 0x7FFFFFF0

# Default metablock span (1 << the auto lgblock of the optimal-parse
# tiers); the live span comes from params.lgblock.
METABLOCK_SIZE = 1 << 22

# inputs of at least this many bytes take the dual-session parse at the
# ring tiers
DUAL_PARSE_MIN = 1 << 21


def compress(data, quality: int = 11, lgwin: int = 22, lgblock: int = 0,
             mode: int = 0, catable: bool = False, appendable: bool = False,
             bare: bool = False, byte_align: bool = False,
             magic_number: bool = False, large_window: bool = False,
             custom_dictionary: bytes = b"", q9_5: bool = False,
             q10_deep: bool = False,
             literal_byte_score: int = 540,
             avoid_distance_prefix_search: bool = False,
             disable_literal_context_modeling: bool = False,
             stream_offset: int = 0,
             metablock_callback=None,
             literal_probabilities=None) -> bytes:
    """One-shot compress (reference BrotliCompress).

    metablock_callback: called once per metablock with the list of IR
    commands (utils.ir vocabulary) for that block and the block's
    bytes.  literal_probabilities: one byte a input byte, carried on
    the IR's Literal records."""
    data = np.frombuffer(bytes(data), dtype=np.uint8)
    params = EncoderParams(
        quality=quality, lgwin=lgwin, lgblock=lgblock, mode=mode,
        catable=catable, appendable=appendable, bare=bare,
        byte_align=byte_align, magic_number=magic_number,
        large_window=large_window, q9_5=q9_5, q10_deep=q10_deep,
        literal_byte_score=literal_byte_score,
        avoid_distance_prefix_search=avoid_distance_prefix_search,
        disable_literal_context_modeling=disable_literal_context_modeling,
        stream_offset=stream_offset,
        log_meta_block=metablock_callback is not None,
    ).sanitize(len(data))
    if params.catable:
        custom_dictionary = b""  # catable forbids dictionaries (SanitizeParams)
    out = compress_with_params(data, params, custom_dictionary,
                               metablock_callback=metablock_callback,
                               literal_probabilities=literal_probabilities)
    # Whole-stream fallback: never exceed the uncompressed-stream bound
    # (reference encoder_compress, encode.rs:1522-1537).
    plain_flags = not (params.catable or params.appendable or params.bare
                       or params.magic_number or custom_dictionary)
    if plain_flags and len(out) > len(data) + 5:
        alt = make_uncompressed_stream(data, params)
        if len(alt) < len(out):
            return alt
    return out


def make_uncompressed_stream(data: np.ndarray,
                             params: EncoderParams) -> bytes:
    """Raw fallback stream (reference MakeUncompressedStream,
    encode.rs:1388-1433)."""
    w = BitWriter()
    bs.write_stream_header(w, params.lgwin, params.large_window)
    n = len(data)
    pos = 0
    while pos < n:
        chunk = min(n - pos, 1 << 24)
        bs.store_uncompressed_meta_block(
            w, data[pos:pos + chunk].tobytes())
        pos += chunk
    bs.write_empty_last_meta_block(w)
    return w.getvalue()


def _quality_knobs(params: EncoderParams):
    """Match-finder geometry per quality, q0-q9 (the analog of the
    reference's ChooseHasher, encode.rs:834-893: deeper candidate search
    and bigger tables at higher quality)."""
    q = params.quality
    if q <= 1:
        return dict(k=1, bucket_bits=15, k8=0)
    if q <= 3:
        # the basic tier: direct-mapped 2^16 buckets, the reference's
        # 5-byte hash, the last distance probed; q2 sweeps 1 slot, q3 2
        return dict(k=1 if q == 2 else 2, bucket_bits=16, k8=0,
                    n_cache=1, hash_len=5)
    if params.lgwin <= 16 and q >= 4:
        # small windows: small bank-sized tables with bounded-depth
        # chains (the reference's H40/H41/H42 selection)
        if q < 7:
            return dict(k=4, bucket_bits=14, k8=2, bucket_bits8=14,
                        hash_len=4)
        if q < 9:
            return dict(k=8, bucket_bits=14, k8=4, bucket_bits8=14,
                        hash_len=4, n_cache=10)
        return dict(k=16, bucket_bits=15, k8=8, bucket_bits8=15,
                    hash_len=4, n_cache=16)
    if q <= 6:
        return dict(k=7, bucket_bits=16, k8=2, bucket_bits8=16,
                    hash_len=4, n_cache=4)
    # q7-q9: the full 16-candidate short-code probe set (reference H9)
    return dict(k=24, bucket_bits=17, k8=8, bucket_bits8=16, hash_len=4,
                n_cache=16)


def _session(full, params, dlen, start, cache, knobs):
    return nb.ParseSession(
        full, params.window_size, dict_len=dlen, pos0=start,
        initial_cache=cache, literal_byte_score=params.literal_byte_score,
        use_dictionary=not params.catable, **knobs)


def _serial_segments(full, params, boundaries, dlen, start, cache, knobs):
    """In-thread form of _pipelined_segments (no prefetch worker)."""
    sess = _session(full, params, dlen, start, cache, knobs)
    try:
        prev = start
        for b in boundaries:
            yield sess.next(b, (b - prev) // 2 + 2)
            prev = b
    finally:
        sess.close()


def _pipelined_segments(full, params, boundaries, dlen, start, cache,
                        knobs):
    """Parse segments, one per boundary, prefetched one boundary ahead
    on a single worker thread: parse(metablock g + 1) overlaps the
    serialization of g (both native calls release the GIL), and the
    segments equal the single whole-input parse."""
    sess = _session(full, params, dlen, start, cache, knobs)
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(sess.next, boundaries[0],
                        (boundaries[0] - start) // 2 + 2)
        for i in range(len(boundaries)):
            seg = fut.result()
            if i + 1 < len(boundaries):
                span = boundaries[i + 1] - boundaries[i]
                fut = ex.submit(sess.next, boundaries[i + 1],
                                span // 2 + 2)
            yield seg
    finally:
        ex.shutdown(wait=True)
        sess.close()


def _dual_parse_segments(full, params, boundaries, dlen, start, cache,
                         knobs):
    """Two parse sessions over the same input, each metablock of 512 KiB
    or more split at its midpoint: session A parses the first half
    while session B, whose tables were advanced over A's half by
    insert-only priming, parses the second, and the two command runs
    join into the metablock's segment.  The output differs slightly
    from the single-session parse (copies stop at the seam; each
    session's distance cache sees only its own halves, and wire
    distances resolve against the true rolling cache at store time, so
    streams stay valid).  Smaller metablocks: A parses them whole while
    B only primes.  At most two metablocks are in flight, so the parse
    workers run no further ahead of the store than that."""
    sa = _session(full, params, dlen, start, cache, knobs)
    sb = _session(full, params, dlen, start, cache, knobs)
    ex_a = ThreadPoolExecutor(max_workers=1)
    ex_b = ThreadPoolExecutor(max_workers=1)
    futs = deque()
    bl = list(boundaries)

    def submit_one(gi):
        prev_b = start if gi == 0 else bl[gi - 1]
        b = bl[gi]
        span = b - prev_b
        if span < (1 << 19):
            fa = ex_a.submit(sa.next, b, span // 2 + 2)
            primes = [ex_b.submit(sb.prime, b)]
            futs.append((fa, None, primes))
        else:
            mid = prev_b + span // 2
            fa = ex_a.submit(sa.next, mid, (mid - prev_b) // 2 + 2)
            primes = [ex_a.submit(sa.prime, b), ex_b.submit(sb.prime, mid)]
            fb = ex_b.submit(sb.next, b, (b - mid) // 2 + 2)
            futs.append((fa, fb, primes))

    submitted = min(2, len(bl))
    for gi in range(submitted):
        submit_one(gi)
    try:
        while futs:
            fa, fb, primes = futs.popleft()
            if submitted < len(bl):
                submit_one(submitted)
                submitted += 1
            a = fa.result()
            for f in primes:
                f.result()
            if fb is None:
                yield a
                continue
            ai, ac, ad, aa = a
            bi, bc, bd, ba = (x.copy() for x in fb.result())
            if len(ai) and ac[-1] == 0 and aa[-1] == 0 and len(bi):
                # A's trailing insert-only command is wire-legal only as
                # a metablock's final command: mid-block it folds into
                # the insert run of B's first command (B always emits at
                # least its own trailing command)
                bi[0] += ai[-1]
                ai, ac, ad, aa = ai[:-1], ac[:-1], ad[:-1], aa[:-1]
            yield (np.concatenate([ai, bi]), np.concatenate([ac, bc]),
                   np.concatenate([ad, bd]), np.concatenate([aa, ba]))
    finally:
        ex_a.shutdown(wait=True)
        ex_b.shutdown(wait=True)
        sa.close()
        sb.close()


def _zopfli_segments(full, params, boundaries, dlen, start, cache):
    """The optimal parse's segments, one per boundary.  Each metablock is
    parsed with up to a window of the bytes before it as its dictionary
    and from the rolling distance cache `cache`, a list the store loop
    updates in place before it asks for the next segment; metablock g +
    1's candidates (cache-independent) are collected on a worker thread
    while g is parsed and stored, one metablock ahead and no further."""
    if params.q9_5:
        iters = 2 if params.quality >= 12 else 1
    elif params.quality == 10 and not params.q10_deep:
        # the reference maps one-shot q10 to 9.5 (encode.rs:1470-1482)
        iters = 1
    else:
        iters = None

    def region(i):
        region_start = dlen + (start if i == 0 else boundaries[i - 1])
        keep = min(region_start, params.window_size)
        return full[region_start - keep:dlen + boundaries[i]], keep

    if len(boundaries) == 1:
        r, keep = region(0)
        yield zopfli_segment(r, params, dict_len=keep,
                             initial_cache=tuple(cache), iters=iters)
        return

    def collect(i):
        r, keep = region(i)
        return zopfli_collect(r, params, keep, iters)

    ex = ThreadPoolExecutor(max_workers=1)
    try:
        pending = ex.submit(collect, 0)
        for i in range(len(boundaries)):
            col = pending.result()
            if i + 1 < len(boundaries):
                pending = ex.submit(collect, i + 1)
            r, keep = region(i)
            yield zopfli_segment(r, params, dict_len=keep,
                                 initial_cache=tuple(cache), iters=iters,
                                 precollected=col)
    finally:
        ex.shutdown(wait=True)


def _pipelined_fragment_segments(full, params, boundaries, start):
    """The fragment tier's _pipelined_segments: one fragment_parse_seg
    call per metablock, prefetched one boundary ahead on a single
    worker thread (its persistent table is the thread's own)."""
    ex = ThreadPoolExecutor(max_workers=1)
    window = params.window_size
    try:
        fut = ex.submit(nb.fragment_parse_seg, full, window, start,
                        boundaries[0], True)
        for i in range(len(boundaries)):
            seg = fut.result()
            if i + 1 < len(boundaries):
                fut = ex.submit(nb.fragment_parse_seg, full, window,
                                boundaries[i], boundaries[i + 1], False)
            # its buffer of span / 4 + 16 commands cannot overflow: every
            # command but the trailing insert advances by a copy of >= 4
            if seg is None:
                raise RuntimeError("fragment_parse_seg: command buffer "
                                   "overflow")
            yield seg
    finally:
        ex.shutdown(wait=True)


def compress_with_params(data: np.ndarray, params: EncoderParams,
                         custom_dictionary: bytes = b"",
                         metablock_callback=None,
                         literal_probabilities=None,
                         pipeline: bool = True) -> bytes:
    """The stream of `data` under sanitized `params`.  pipeline=False
    parses in the calling thread (CompressMulti's workers, each already
    one shard on one core)."""
    n = len(data)
    w = BitWriter()
    # only catable+bare streams omit the window header (reference
    # ensure_initialized, encode.rs:676)
    if not (params.bare and params.catable):
        bs.write_stream_header(w, params.lgwin, params.large_window)
    if params.magic_number:
        bs.write_magic_number(w, params.size_hint, catable=params.catable,
                              appendable=params.appendable)

    start = 0
    cache = list(C.INITIAL_DISTANCE_CACHE)
    if params.catable and n > 0:
        # First bytes stored raw so the stream's first compressed
        # metablock is byte-re-alignable by BroCatli and context seeding
        # is position-independent (reference encode.rs:2258-2333).
        cache = [POISONED_DISTANCE] * 4
        k = min(2, n)
        bs.store_uncompressed_meta_block(w, data[:k].tobytes())
        start = k

    if start >= n:
        _finish_stream(w, params)
        return w.getvalue()

    dict_arr = np.frombuffer(bytes(custom_dictionary), dtype=np.uint8)
    dlen = len(dict_arr)
    full = np.concatenate([dict_arr, data]) if dlen else data

    span = 1 << params.lgblock
    boundaries = list(range(start + span, n, span)) + [n]
    suppress = params.appendable or params.byte_align
    knobs = _quality_knobs(params)
    # the whole-stream native pipelines serve plain streams only.  They
    # write the distance trees for the alphabet of the RFC's window, so
    # a large-window stream takes the per-metablock route instead: the
    # JAX package sends it to the pipelines too, and its stream then
    # does not decode where a distance tree is a simple prefix code
    whole = (dlen == 0 and start == 0 and metablock_callback is None
             and params.stream_offset == 0 and not params.large_window)
    native = nb.available()
    if params.quality >= 10:
        segments = _zopfli_segments(full, params, boundaries, dlen, start,
                                    cache)
    elif not native:
        bl, bd, bsc, isd, bw = find_best_matches(
            full, params.window_size, dict_len=dlen,
            literal_byte_score=params.literal_byte_score,
            use_dictionary=not params.catable, **knobs)
        segments = greedy_parse(full, bl, bd, bsc, boundaries, dlen, start,
                                tuple(cache), isd, params.window_size, bw)
    elif params.quality <= 1 and dlen == 0:
        # q0/q1 fragment tier (reference BrotliCompressFragmentFast):
        # one direct-mapped table, greedy one-pass, miss-skip stride, no
        # dictionary and no distance-cache probes
        if whole:
            res = nb.compress_fragment_pipeline(
                full, params.window_size, span, params.quality, suppress,
                tuple(cache), bit_phase=w.bitpos)
            if res is not None:
                return _append_whole(w, res, params)
        segments = _pipelined_fragment_segments(full, params, boundaries,
                                                start)
    elif (params.quality <= 3 and whole
          and not params.disable_literal_context_modeling):
        # q2/q3 basic tier: parse worker, trivial store and bit assembly
        # in one native call
        res = nb.compress_session_pipeline(
            full, params.window_size, span, params.quality, suppress,
            tuple(cache), bit_phase=w.bitpos,
            use_dictionary=not params.catable, **knobs)
        if res is not None:
            return _append_whole(w, res, params)
        segments = _pipelined_segments(full, params, boundaries, dlen,
                                       start, tuple(cache), knobs)
    elif (pipeline and len(full) - dlen >= DUAL_PARSE_MIN
          and knobs.get("n_cache", 1) > 1):
        # large inputs at the ring tiers: two parse workers beside the
        # store thread
        segments = _dual_parse_segments(full, params, boundaries, dlen,
                                        start, tuple(cache), knobs)
    elif pipeline:
        segments = _pipelined_segments(full, params, boundaries, dlen,
                                       start, tuple(cache), knobs)
    else:
        segments = _serial_segments(full, params, boundaries, dlen, start,
                                    tuple(cache), knobs)

    if (native and metablock_callback is None
            and params.stream_offset == 0 and params.quality < 10):
        _store_fused(w, data, full, dlen, start, segments, boundaries,
                     params, cache)
    else:
        _store_unfused(w, full, dlen, start, segments, boundaries, params,
                       cache, metablock_callback, literal_probabilities)
    if suppress:
        _write_trailer(w, params)
    return w.getvalue()


def _append_whole(w: BitWriter, res, params: EncoderParams) -> bytes:
    """The stream of a whole-stream native pipeline's (words, nbits,
    cache), assembled at the writer's bit phase."""
    words, nbits, _ = res
    w.append_packed_phased(words, nbits, w.bitpos)
    if params.appendable or params.byte_align:
        _write_trailer(w, params)
    return w.getvalue()


def _store_fused(w, data, full, dlen, start, segments, boundaries, params,
                 cache):
    """One fused native resolve + plan + serialize call per metablock.
    Below q4 the same call runs with context modeling and block splits
    off: that wire shape is the trivial store."""
    suppress = params.appendable or params.byte_align
    seg_start = start
    for i, (seg, boundary) in enumerate(zip(segments, boundaries)):
        ins, cps, dst, adv = seg
        mlen = boundary - seg_start
        is_last = i == len(boundaries) - 1 and not suppress
        abs_start = dlen + seg_start
        if params.disable_literal_context_modeling:
            # one literal tree per block type: zero context LUTs collapse
            # every context to 0 (reference param 4)
            ctx_mode, nlc, smap = 0, 1, np.zeros(64, dtype=np.int64)
            lut0 = lut1 = np.zeros(256, dtype=np.uint8)
        else:
            ctx_mode, nlc, smap = choose_literal_context(
                full, abs_start, mlen, params.quality, params.mode,
                params.size_hint)
            lut0 = C.CONTEXT_LUT0[ctx_mode]
            lut1 = C.CONTEXT_LUT1[ctx_mode]
        res = nb.encode_metablock(
            full, abs_start, mlen, is_last, ins, cps, dst, adv, cache,
            params.window_size, params.dist.npostfix, params.dist.ndirect,
            params.dist.alphabet_size, params.quality, ctx_mode, nlc, smap,
            lut0, lut1, enable_splits=params.quality >= 4)
        new_cache = bs.append_native(w, res, mlen)
        if new_cache is None:
            bs.store_raw(w, data[seg_start:boundary], is_last)
        else:
            cache = new_cache
        seg_start = boundary


def _store_unfused(w, full, dlen, start, segments, boundaries, params,
                   cache, metablock_callback, literal_probabilities):
    """Commands resolved in Python, handed to the IR callback, then
    stored: the optimized native store at q4 and above, the trivial
    store below.  At quality 10 and above each metablock takes the
    NPOSTFIX/NDIRECT of least distance-stream cost (reference
    BrotliBuildMetaBlock, metablock.rs:158-208) unless
    avoid_distance_prefix_search.  `cache`, the rolling distance cache,
    is updated in place after each metablock kept compressed."""
    suppress = params.appendable or params.byte_align
    probs_full = None
    if literal_probabilities is not None:
        probs_full = np.concatenate([
            np.zeros(dlen, np.uint8),
            np.frombuffer(bytes(literal_probabilities), np.uint8)])
    seg_start = start
    for i, (seg, boundary) in enumerate(zip(segments, boundaries)):
        ins, cps, dst, adv = seg
        mlen = boundary - seg_start
        # appendable/byte_align streams never set ISLAST on content
        # blocks; the trailer is written separately (encode.rs:1973,
        # :2165)
        is_last = i == len(boundaries) - 1 and not suppress
        pos_offset = dlen + seg_start + params.stream_offset
        dist_params = params.dist
        cmds, new_cache = resolve_commands(
            ins, cps, dst, dist_params, advance=adv, initial_cache=cache,
            pos_offset=pos_offset, window_size=params.window_size)
        if params.quality >= 10 and not params.avoid_distance_prefix_search:
            better = choose_distance_params(
                cmds.distance, cmds.copy_len > 0, cmds.dist_code,
                large_window=params.large_window)
            if (better.npostfix, better.ndirect) != (dist_params.npostfix,
                                                     dist_params.ndirect):
                dist_params = better
                cmds, new_cache = resolve_commands(
                    ins, cps, dst, dist_params, advance=adv,
                    initial_cache=cache, pos_offset=pos_offset,
                    window_size=params.window_size)
        if metablock_callback is not None:
            ir_cmds = ir_from_commands(
                full, dlen + seg_start, cmds, pos_offset=pos_offset,
                window_size=params.window_size, lit_probs=probs_full)
            metablock_callback(
                ir_cmds, bytes(full[dlen + seg_start:dlen + boundary]))
        if bs.store_meta_block_or_raw(
                w, full, dlen + seg_start, mlen, cmds, dist_params,
                params.quality, params.size_hint, params.mode, is_last,
                disable_literal_context_modeling=params.
                disable_literal_context_modeling):
            cache[:] = new_cache
        seg_start = boundary


def _write_trailer(w: BitWriter, params: EncoderParams):
    """Stream trailer when ISLAST was suppressed on content blocks
    (reference WriteEmptyLastBlocksInternal, encode.rs:1928): padding
    metablock for byte alignment, then the '11' empty-last metablock
    unless the stream is bare."""
    if params.byte_align:
        bs.write_padding_meta_block(w)
    if not params.bare:
        bs.write_empty_last_meta_block(w)


def _finish_stream(w: BitWriter, params: EncoderParams):
    if params.appendable or params.byte_align:
        _write_trailer(w, params)
    else:
        bs.write_empty_last_meta_block(w)
