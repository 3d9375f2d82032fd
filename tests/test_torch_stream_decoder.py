"""The port's StreamDecoder against brotli_tpu's, on the CPU.

Streams: brotli_tpu.compress's, the port's compress's and libbrotlienc's
(tests/oracle.py) at q0, q5, q9 and q11 over lgwin 10-24, and streams
with a custom dictionary and a large window.  Each is fed to both
packages' StreamDecoder in the same pieces (1, 97 and 4096 bytes, or
whole) with the same max_output (none, 1, 1000): every call of the port
returns what the JAX call returns (tolerance: none), and where one
raises, the other raises the same error at the same call.  Also: a
truncated stream raises at finish(), a flipped byte raises
BrotliDecodeError at the same call in both and stays raised, the kept
window stays bounded, the reader's consumed input is dropped past its
slack (set to 64 bytes in both packages, so small streams cross it many
times), and a single-metablock stream fed in 97-byte pieces costs at
most one command decode more per piece than its commands, the same
count as the JAX package's.
"""

import functools

import numpy as np
import pytest

import brotli_tpu
import brotli_tpu.core.bitio as jax_bitio
import brotli_tpu.decode.decoder as jax_decoder
import brotli_tpu_torch
from brotli_tpu_torch import StreamDecoder
from brotli_tpu_torch.core import bitio
from brotli_tpu_torch.decode import decoder as D
from . import oracle
from .test_torch_encoder import (CUSTOM_DICTIONARY, dictionary_slice,
                                 phrases)
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = (phrases(12_000, seed=61) + dictionary_slice(5_000, 7_000)
        + np.random.default_rng(62).integers(0, 256, 1_000,
                                             dtype=np.uint8).tobytes())
PACKAGES = (brotli_tpu, brotli_tpu_torch)
ENCODERS = {"brotli_tpu": brotli_tpu.compress,
            "brotli_tpu_torch": brotli_tpu_torch.compress,
            "libbrotlienc": lambda d, quality, lgwin: oracle.compress(
                d, quality=quality, lgwin=lgwin)}


@functools.lru_cache(maxsize=None)
def _stream(encoder, quality, lgwin, n=len(DATA)):
    return ENCODERS[encoder](DATA[:n], quality=quality, lgwin=lgwin)


def _feed(pkg, stream, step=None, max_output=None, **kw):
    """Each call's return, in order, through finish(); an error ends the
    list as (call index, error name, message)."""
    sd = pkg.StreamDecoder(**kw)
    calls = []
    try:
        pieces = [stream] if step is None else [
            stream[i:i + step] for i in range(0, len(stream), step)]
        for piece in pieces:
            calls.append(sd.decompress(piece, max_output=max_output))
        while max_output is not None and not sd.finished:
            got = sd.decompress(b"", max_output=max_output)
            calls.append(got)
            if not got:
                break
        while max_output is not None and sd.has_more_output:
            calls.append(sd.decompress(b"", max_output=max_output))
        calls.append(sd.finish())
    except Exception as e:  # noqa: BLE001 -- compared by name
        calls.append((len(calls), type(e).__name__, str(e)))
    return calls


def _same_calls(stream, step=None, max_output=None, **kw):
    want = _feed(brotli_tpu, stream, step, max_output, **kw)
    got = _feed(brotli_tpu_torch, stream, step, max_output, **kw)
    assert got == want
    return got


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
@pytest.mark.parametrize("quality,lgwin", [(0, 10), (5, 16), (9, 22),
                                           (11, 24)])
def test_streams_match_jax_call_for_call(encoder, quality, lgwin):
    stream = _stream(encoder, quality, lgwin)
    for step in (None, 4096):
        calls = _same_calls(stream, step)
        assert b"".join(calls) == DATA


@pytest.mark.parametrize("step", [1, 97, 4096, None])
@pytest.mark.parametrize("max_output", [None, 1, 1000])
def test_chunkings_and_max_output_match_jax(step, max_output):
    data = DATA[:6_000] if step == 1 or max_output == 1 else DATA
    stream = _stream("brotli_tpu", 9, 16, len(data))
    calls = _same_calls(stream, step, max_output)
    assert b"".join(calls) == data
    if max_output is not None:
        assert max(map(len, calls[:-1])) <= max_output


@pytest.mark.parametrize("quality", [5, 11])
def test_custom_dictionary_and_large_window_match_jax(quality):
    data = DATA[:8_000]
    for pkg in PACKAGES:
        stream = pkg.compress(data, quality=quality,
                              custom_dictionary=CUSTOM_DICTIONARY)
        calls = _same_calls(stream, 97, custom_dictionary=CUSTOM_DICTIONARY)
        assert b"".join(calls) == data
        stream = pkg.compress(data, quality=quality, large_window=True,
                              lgwin=26)
        calls = _same_calls(stream, 4096, large_window=True)
        assert b"".join(calls) == data
        # without large_window both refuse its header alike
        assert _same_calls(stream)[-1][1] == "BrotliDecodeError"


def test_truncation_raises_at_finish_in_both():
    stream = brotli_tpu.compress(DATA, quality=5, lgwin=16)
    for cut in (1, 2, 17, len(stream) // 2, len(stream) - 1):
        calls = _same_calls(stream[:cut], 97)
        index, name, _ = calls[-1]
        assert name == "BrotliDecodeError"
        assert index == len(calls) - 1 == -(-cut // 97)  # at finish()


def test_flipped_byte_raises_at_the_same_call_and_stays_raised():
    stream = _stream("brotli_tpu", 9, 16)
    rng = np.random.default_rng(63)
    raised = 0
    for at in rng.integers(1, len(stream) - 1, 12):
        bad = bytearray(stream)
        bad[at] ^= 0xFF
        calls = _same_calls(bytes(bad), 97)
        if not isinstance(calls[-1], tuple):
            continue
        raised += 1
        assert calls[-1][1] == "BrotliDecodeError"
        for pkg in PACKAGES:
            sd = pkg.StreamDecoder()
            with pytest.raises(Exception) as first:
                for i in range(0, len(bad), 97):
                    sd.decompress(bytes(bad[i:i + 97]))
                sd.finish()
            for later in (b"", bytes(stream[:5])):
                with pytest.raises(type(first.value)) as again:
                    sd.decompress(later)
                assert again.value is first.value
            with pytest.raises(type(first.value)):
                sd.finish()
    assert raised >= 4


@pytest.mark.parametrize("lgwin", [10, 12])
def test_window_stays_bounded(lgwin):
    stream = brotli_tpu_torch.compress(DATA, quality=5, lgwin=lgwin)
    window = (1 << lgwin) - 16
    chunk = 4096
    sd = StreamDecoder()
    out = bytearray()
    for i in range(0, len(stream), chunk):
        out += sd.decompress(stream[i:i + chunk])
        assert len(sd._out._buf) <= window + chunk
    out += sd.finish()
    assert bytes(out) == DATA
    assert sd.total_out == len(DATA)


def test_reader_drops_consumed_input_past_its_slack(monkeypatch):
    monkeypatch.setattr(jax_bitio.BitReader, "_SLACK_BYTES", 64)
    monkeypatch.setattr(bitio.BitReader, "_SLACK_BYTES", 64)
    for pkg in PACKAGES:
        stream = _stream(pkg.__name__, 9, 16)
        for step, max_output in ((97, None), (4096, 1000)):
            calls = _same_calls(stream, step, max_output)
            assert b"".join(calls) == DATA
    head = brotli_tpu.compress(DATA[:4_000], quality=5, lgwin=16)
    assert b"".join(_same_calls(head, 1)) == DATA[:4_000]
    sd = StreamDecoder()
    r = sd._reader
    for i in range(0, len(stream), 97):
        unread = (r.bit_len - r.bit_pos + 7) // 8
        sd.decompress(stream[i:i + 97])
        # the slack, the byte in progress, what was unread and the piece
        assert len(r.data) <= 64 + 1 + unread + 97
    assert sd.finish() == b""
    assert r.base % 8 == 0 and r.base >= 8 * (len(stream) // 2)


def _count_commands(monkeypatch, cls):
    counter = [0]
    real = cls._one_command

    def counted(self, *args):
        counter[0] += 1
        return real(self, *args)
    monkeypatch.setattr(cls, "_one_command", counted)
    return counter


def test_resume_stays_linear_by_command_count(monkeypatch):
    """A single-metablock stream fed in 97-byte pieces: each piece rolls
    back at most one command, so the command decodes are at most the
    commands plus the pieces, and equal to the JAX package's."""
    data = phrases(40_000, seed=64)
    stream = brotli_tpu.compress(data, quality=5, lgwin=18)
    headers = []
    real_header = D.Decoder._parse_metablock_header
    monkeypatch.setattr(D.Decoder, "_parse_metablock_header",
                        lambda self, r, mlen: headers.append(mlen)
                        or real_header(self, r, mlen))
    ours = _count_commands(monkeypatch, D.Decoder)
    theirs = _count_commands(monkeypatch, jax_decoder.Decoder)
    assert D.Decoder().decompress(stream) == data
    commands = ours[0]
    assert headers == [len(data)]  # one compressed metablock
    ours[0] = 0
    feeds = -(-len(stream) // 97) + 1  # the pieces and finish()
    calls = _same_calls(stream, 97)
    assert b"".join(calls) == data
    assert ours[0] == theirs[0]
    assert commands < ours[0] <= commands + feeds
    assert len(stream) > 97 * 50
