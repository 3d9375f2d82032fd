"""The port's streaming Compressor against brotli_tpu's, on the CPU.

Each case drives both packages' Compressor through the same calls
(process in pieces, flush and emit_metadata between chunks, finish) and
asserts that every call returns the same bytes (tolerance: none); the
joined stream then decodes through libbrotlidec (tests/oracle.py; a
stream with a custom dictionary or a stream_offset is first spliced
behind the bytes before it) and through the port's StreamDecoder.
Cases: q0, q1, q2, q5, q9, q10 and q11; the catable, appendable,
byte_align, magic_number, stream_offset (of a catable part) and
custom_dictionary flags, and stream_offset alone;
chunk sizes 1, 8 KiB and 1 << 26 (clamped to 1 << 24); lgwin 16 with
8 KiB chunks over more than 8 chunks, where the parse session compacts;
the route without a native session (the match finder and the greedy
parse a chunk); the empty stream; and the streamed size within 0.5% of
one-shot compress at q5 and q9.
"""

import numpy as np
import pytest

import brotli_tpu
from brotli_tpu import native_bridge as jax_nb
import brotli_tpu_torch
from brotli_tpu_torch import Compressor, StreamDecoder
from brotli_tpu_torch import native_bridge as nb
from .test_torch_encoder import (CUSTOM_DICTIONARY, PREFIX, decodes,
                                 dictionary_slice, phrases)
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = (phrases(20_000, seed=71) + dictionary_slice(40_000, 42_000)
        + np.random.default_rng(72).integers(0, 256, 2_000,
                                             dtype=np.uint8).tobytes())
PIECE = 5_000
FLAGS = {
    "catable": dict(catable=True),
    "appendable": dict(appendable=True),
    "byte_align": dict(byte_align=True),
    "magic_number": dict(magic_number=True),
    # a catable continuation at its offset in the larger stream
    "stream_offset": dict(catable=True, stream_offset=len(PREFIX)),
    "custom_dictionary": dict(custom_dictionary=CUSTOM_DICTIONARY),
}


def _calls(pkg, data, piece=PIECE, flush_at=(2,), metadata_at=(3,),
           **params):
    """Every call's output: process() of each piece, flush() and
    emit_metadata() after the pieces named, then finish()."""
    c = pkg.Compressor(**params)
    outs = []
    for k, at in enumerate(range(0, len(data), piece)):
        outs.append(c.process(data[at:at + piece]))
        if k in flush_at:
            outs.append(c.flush())
        if k in metadata_at:
            outs.append(c.emit_metadata(b"metadata %d" % k))
    outs.append(c.finish())
    assert c.is_finished()
    return outs


def _check(data, **params) -> bytes:
    """Both packages' calls equal; the stream decodes through
    libbrotlidec and the port's StreamDecoder."""
    want = _calls(brotli_tpu, data, **params)
    got = _calls(brotli_tpu_torch, data, **params)
    assert got == want
    stream = b"".join(got)
    before = params.get("custom_dictionary", b"")
    if params.get("stream_offset"):
        # positions start at the offset: the bytes before it are the
        # decoder's dictionary
        before = PREFIX
    decodes(stream, data, dictionary=before)
    sd = StreamDecoder(custom_dictionary=before)
    assert sd.decompress(stream) + sd.finish() == data
    return stream


@pytest.mark.parametrize("quality", [0, 1, 2, 5, 9, 10, 11])
def test_qualities_match_jax_call_for_call(quality):
    _check(DATA, quality=quality, chunk_size=8 << 10)


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("quality", [1, 5, 11])
def test_stream_flags_match_jax_call_for_call(flag, quality):
    _check(DATA, quality=quality, chunk_size=8 << 10, **FLAGS[flag])


@pytest.mark.parametrize("quality", [1, 5])
@pytest.mark.parametrize("chunk_size", [1, 8 << 10, 1 << 26])
def test_chunk_sizes_match_jax(quality, chunk_size):
    data = DATA[:300] if chunk_size == 1 else DATA
    piece = 100 if chunk_size == 1 else PIECE
    _check(data, quality=quality, chunk_size=chunk_size, piece=piece)
    assert Compressor(chunk_size=chunk_size).chunk_size == min(
        chunk_size, 1 << 24) == brotli_tpu.Compressor(
            chunk_size=chunk_size).chunk_size


@pytest.mark.parametrize("quality", [5, 9])
def test_session_compaction_at_lgwin16_matches_jax(quality, monkeypatch):
    """More than 8 chunks of 8 KiB fill the session's buffer of window +
    8 chunks: it compacts to the window and a new session starts."""
    starts = []
    real = nb.ParseSession

    def counted(*args, **kw):
        starts.append(args[1])
        return real(*args, **kw)
    monkeypatch.setattr(nb, "ParseSession", counted)
    data = phrases(120_000, seed=73)
    stream = _check(data, quality=quality, lgwin=16, chunk_size=8 << 10,
                    piece=8 << 10, flush_at=(4, 11), metadata_at=(9,))
    assert len(starts) >= 2
    assert len(stream) < len(data) // 2


@pytest.mark.parametrize("quality", [1, 5, 9])
def test_route_without_native_session_matches_jax(quality, monkeypatch):
    """With no native session below q10 each chunk runs the match finder
    and the greedy parse against the carried context."""
    monkeypatch.setattr(jax_nb, "available", lambda: False)
    monkeypatch.setattr(nb, "available", lambda: False)
    monkeypatch.setattr(nb, "ParseSession", None)
    _check(DATA[:12_000], quality=quality, chunk_size=4 << 10)


@pytest.mark.parametrize("quality", [5, 10, 11])
def test_stream_offset_without_catable_matches_jax(quality):
    """Not catable, the part may use static-dictionary words.  Below q10
    the stream decodes behind the bytes before its offset; at q10 and
    above the optimal parser places dictionary words as if the stream
    started at position 0, in the JAX package as in the port (ROADMAP
    queue 3): the bytes and both packages' decoders agree there."""
    params = dict(quality=quality, chunk_size=8 << 10,
                  stream_offset=len(PREFIX))
    got = _calls(brotli_tpu_torch, DATA, **params)
    assert got == _calls(brotli_tpu, DATA, **params)
    stream = b"".join(got)
    outcomes = []
    for pkg in (brotli_tpu, brotli_tpu_torch):
        try:
            outcomes.append(pkg.Decoder(custom_dictionary=PREFIX)
                            .decompress(stream))
        except Exception as e:  # noqa: BLE001 -- compared by name
            outcomes.append(type(e).__name__)
    assert outcomes[0] == outcomes[1]
    if quality < 10:
        assert outcomes[1] == DATA
        decodes(stream, DATA, dictionary=PREFIX)


@pytest.mark.parametrize("quality", [1, 5, 11])
def test_empty_and_tiny_streams_match_jax(quality):
    for data in (b"", b"a", b"ab", b"abc"):
        for flags in ({}, dict(catable=True), dict(byte_align=True)):
            _check(data, quality=quality, **flags)


def test_streamed_size_near_one_shot():
    """Streaming in 64 KiB chunks stays within 0.5% of one-shot compress
    at the greedy tiers (the session carries the cross-chunk context)."""
    data = phrases(400_000, seed=74)
    for q in (5, 9):
        one = brotli_tpu_torch.compress(data, quality=q)
        stream = _check(data, quality=q, chunk_size=1 << 16, piece=1 << 16)
        assert len(stream) <= len(one) * 1.005, (q, len(stream), len(one))


def test_finish_releases_the_session_and_closes():
    c = Compressor(quality=5, chunk_size=4096)
    c.process(DATA)
    assert c._sess is not None
    c.finish()
    assert c._sess is None
    for call in (lambda: c.process(b"x"), c.flush, c.finish,
                 lambda: c.emit_metadata(b"m")):
        with pytest.raises(RuntimeError, match="already finished"):
            call()
