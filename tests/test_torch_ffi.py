"""The port's FFI (brotli_tpu_torch.ffi, the C API's shape) against
brotli_tpu.ffi, on the CPU.

The scenarios of tests/test_ffi.py that touch the FFI, rebuilt on
in-repo inputs (seeded phrases, random bytes and the RFC dictionary):
an encoder instance over PROCESS, FLUSH, EMIT_METADATA and FINISH with
TakeOutput in 4 KiB bites, the one-shot and preallocated encoders and
their bounds, a decoder instance fed in pieces, the one-shot and
preallocated decoders (a buffer too small among them), CompressMulti,
and a corrupt stream.  Every call's return value and bytes are the JAX
package's (tolerance: none): the FFI returns failure where its core
raises, so each success is asserted as well, and every encoded stream
decodes through libbrotlidec (tests/oracle.py).  The compress-only
scenarios of tests/test_ffi.py (metablock callback, literal
probabilities, stream flags) are tests/test_torch_encoder.py's; the
utils scenarios wait for the port of utils/.
"""

import ctypes

import numpy as np
import pytest

from brotli_tpu import ffi as jax_ffi
from brotli_tpu_torch import ffi
from . import oracle
from .test_torch_encoder import CUSTOM_DICTIONARY, dictionary_slice, phrases
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FFIS = (jax_ffi, ffi)
DATA = (phrases(60_000, seed=91) + dictionary_slice(10_000, 14_000)
        + np.random.default_rng(92).integers(0, 256, 2_000,
                                             dtype=np.uint8).tobytes())


def _both(run):
    """run(ffi module) for each package; the results must be equal."""
    want, got = (run(f) for f in FFIS)
    assert got == want
    return got


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


def test_public_names_and_constants_match_jax():
    assert _public(ffi) == _public(jax_ffi)
    for name in _public(jax_ffi):
        if name.startswith("BROTLI_"):
            assert getattr(ffi, name) == getattr(jax_ffi, name), name
    assert ffi.BrotliEncoderVersion() == jax_ffi.BrotliEncoderVersion() > 0
    assert ffi.BrotliDecoderVersion() == jax_ffi.BrotliDecoderVersion() > 0


def _encode_instance(f, data, params, piece=30_000, dictionary=b""):
    """Every call of an encoder instance, as (call, its return), in
    order, and the stream its TakeOutput bites make."""
    st = f.BrotliEncoderCreateInstance()
    calls = [("set", f.BrotliEncoderSetParameter(st, k, v))
             for k, v in params]
    if dictionary:
        f.BrotliEncoderSetCustomDictionary(st, dictionary)
    out = bytearray()

    def take(max_bytes):
        bite = f.BrotliEncoderTakeOutput(st, max_bytes)
        calls.append(("take", bite))
        out.extend(bite)
    for k, at in enumerate(range(0, len(data), piece)):
        calls.append(("process", f.BrotliEncoderCompressStream(
            st, f.BROTLI_OPERATION_PROCESS, data[at:at + piece])))
        if k == 1:
            # parameters are frozen once input has come
            calls.append(("set late", f.BrotliEncoderSetParameter(
                st, f.BROTLI_PARAM_QUALITY, 3)))
            calls.append(("flush", f.BrotliEncoderCompressStream(
                st, f.BROTLI_OPERATION_FLUSH)))
        if k == 2:
            calls.append(("metadata", f.BrotliEncoderCompressStream(
                st, f.BROTLI_OPERATION_EMIT_METADATA, metadata=b"xyz")))
        while f.BrotliEncoderHasMoreOutput(st):
            take(4096)
        calls.append(("finished", f.BrotliEncoderIsFinished(st)))
    calls.append(("finish", f.BrotliEncoderCompressStream(
        st, f.BROTLI_OPERATION_FINISH)))
    take(None)
    calls += [("finished", f.BrotliEncoderIsFinished(st)),
              ("more", f.BrotliEncoderHasMoreOutput(st)),
              ("unknown op", f.BrotliEncoderCompressStream(st, 99))]
    f.BrotliEncoderDestroyInstance(st)
    return calls, bytes(out)


@pytest.mark.parametrize("params", [
    [(1, 7), (2, 22)],                              # test_ffi.py's q7
    [(1, 5), (2, 18), (3, 16)],
    [(1, 1)],
    [(1, 9), (150, 1)],                             # Q9_5 rides q10
    [(1, 11), (0, 1)],
    [(1, 5), (167, 1), (169, 1)],                   # catable, magic
    [(1, 5), (172, 1), (9, 123)],                   # byte_align, offset
    [(1, 9), (168, 1)],                             # appendable
])
def test_encoder_instance_matches_jax(params):
    slow = params[0][1] >= 10 or (150, 1) in params  # the optimal parser
    data = DATA[:24_000] if slow else DATA
    calls, stream = _both(lambda f: _encode_instance(
        f, data, params, piece=8_000 if slow else 30_000))
    for name, value in calls:
        if name in ("set", "process", "flush", "metadata", "finish"):
            assert value is True, name
        elif name in ("set late", "unknown op", "more"):
            assert value is False, name
    assert calls[-3] == ("finished", True)
    assert any(name == "take" and len(v) == 4096 for name, v in calls)
    if dict(params).get(9):
        return  # the offset part decodes only behind its prefix
    assert oracle.decompress(stream, max_size_hint=len(data)) == data


def test_encoder_instance_with_custom_dictionary_matches_jax():
    data = DATA[:30_000]
    calls, stream = _both(lambda f: _encode_instance(
        f, data, [(1, 5)], piece=10_000, dictionary=CUSTOM_DICTIONARY))
    d = ffi.BrotliDecoderCreateInstance()
    ffi.BrotliDecoderSetCustomDictionary(d, CUSTOM_DICTIONARY)
    assert ffi.BrotliDecoderDecompressStream(d, stream) == \
        ffi.BROTLI_DECODER_RESULT_SUCCESS
    assert ffi.BrotliDecoderTakeOutput(d) == data


def test_one_shot_encoders_and_bounds_match_jax():
    for q in (0, 5, 9, 11):
        out = _both(lambda f: f.BrotliEncoderCompress(q, 22, 0, DATA))
        assert oracle.decompress(out, max_size_hint=len(DATA)) == DATA
        assert ffi.BrotliEncoderMaxCompressedSize(len(DATA)) >= len(out)
    assert _both(lambda f: [f.BrotliEncoderMaxCompressedSize(n)
                            for n in (0, 1, 1 << 20, (1 << 24) + 1)])
    for q in (1, 5, 9):
        out = _both(lambda f: f.BrotliEncoderCompressPrealloc(
            q, 22, 0, DATA))
        assert out is not None
        assert oracle.decompress(out, max_size_hint=len(DATA)) == DATA
    # the C API takes the caller's arena; too small, or above q9: None
    assert _both(lambda f: f.BrotliEncoderCompressPrealloc(
        5, 22, 0, DATA, scratch=ctypes.create_string_buffer(1000))) is None
    assert _both(lambda f: f.BrotliEncoderCompressPrealloc(
        10, 22, 0, DATA)) is None


def test_compress_multi_matches_jax():
    for q in (5, 7, 11):
        out = _both(lambda f: f.BrotliEncoderCompressMulti(DATA, 4,
                                                           quality=q))
        assert oracle.decompress(out, max_size_hint=len(DATA)) == DATA
    assert _both(lambda f: f.BrotliEncoderCompressMulti(
        "not bytes", 4)) is None


def _stream(quality=9, lgwin=18, data=DATA):
    return oracle.compress(data, quality=quality, lgwin=lgwin)


def _decode_instance(f, stream, piece, dictionary=b"", large=False):
    """A decoder instance fed `stream` in pieces: (the states before,
    each DecompressStream result, each TakeOutput bite, the states
    after: IsFinished, IsUsed, GetErrorCode, ErrorString)."""
    st = f.BrotliDecoderCreateInstance()
    before = (f.BrotliDecoderIsUsed(st), f.BrotliDecoderIsFinished(st))
    if dictionary:
        f.BrotliDecoderSetCustomDictionary(st, dictionary)
    if large:
        assert f.BrotliDecoderSetParameter(
            st, f.BROTLI_DECODER_PARAM_LARGE_WINDOW, 1)
    results, bites = [], []
    for at in range(0, len(stream), piece):
        results.append(f.BrotliDecoderDecompressStream(
            st, stream[at:at + piece]))
        while f.BrotliDecoderHasMoreOutput(st):
            bites.append(f.BrotliDecoderTakeOutput(st, 5000))
    after = (f.BrotliDecoderIsFinished(st), f.BrotliDecoderIsUsed(st),
             f.BrotliDecoderGetErrorCode(st), f.BrotliDecoderErrorString(st))
    f.BrotliDecoderDestroyInstance(st)
    return before, results, bites, after


@pytest.mark.parametrize("quality", [1, 9, 11])
def test_decoder_instance_matches_jax(quality):
    stream = _stream(quality)
    before, results, bites, after = _both(
        lambda f: _decode_instance(f, stream, 10_000))
    assert b"".join(bites) == DATA
    assert max(map(len, bites)) == 5000
    assert before == (False, False)
    assert results[-1] == ffi.BROTLI_DECODER_RESULT_SUCCESS
    assert set(results[:-1]) <= {ffi.BROTLI_DECODER_RESULT_NEEDS_MORE_INPUT}
    assert after == (True, True, 0, "NO_ERROR")


def test_decoder_instance_large_window_and_dictionary_match_jax():
    from brotli_tpu import compress
    data = DATA[:20_000]
    for what, stream, kw in (
            ("dictionary", compress(data, quality=9,
                                    custom_dictionary=CUSTOM_DICTIONARY),
             dict(dictionary=CUSTOM_DICTIONARY)),
            ("large window", compress(data, quality=9, large_window=True,
                                      lgwin=26), dict(large=True))):
        _, results, bites, after = _both(
            lambda f: _decode_instance(f, stream, 997, **kw))
        assert b"".join(bites) == data, what
        assert results[-1] == ffi.BROTLI_DECODER_RESULT_SUCCESS
        assert after == (True, True, 0, "NO_ERROR")


def test_corrupt_stream_gives_the_error_result_in_both():
    stream = bytearray(_stream())
    stream[40:60] = b"\xff" * 20  # the prefix codes' region
    for piece in (len(stream), 1000):
        _, results, _, after = _both(
            lambda f: _decode_instance(f, bytes(stream), piece))
        assert results[-1] == ffi.BROTLI_DECODER_RESULT_ERROR
        assert after[:3] == (False, True, -1) and after[3] != "NO_ERROR"
    # the one-shot decoder returns None
    assert _both(lambda f: f.BrotliDecoderDecompress(bytes(stream))) is None
    # a truncated stream needs more input and never finishes
    _, results, _, after = _both(lambda f: _decode_instance(
        f, _stream()[:5_000], 1000))
    assert results == [ffi.BROTLI_DECODER_RESULT_NEEDS_MORE_INPUT] * 5
    assert after == (False, True, 0, "NO_ERROR")


def _return_info(f, stream, buf):
    info = f.BrotliDecoderDecompressWithReturnInfo(stream, buf)
    pre = f.BrotliDecoderDecompressPrealloc(stream, buf)
    return [(i.decoded_size, i.error, i.result, i.code) for i in (info, pre)]


def test_preallocated_decoders_match_jax():
    stream = _stream(9)
    assert _both(lambda f: f.BrotliDecoderDecompress(stream)) == DATA
    for buf_of in (lambda: bytearray(len(DATA)),
                   lambda: np.zeros(len(DATA) + 10, np.uint8),
                   lambda: memoryview(bytearray(len(DATA) + 1))):
        bufs = []

        def run(f):
            buf = buf_of()
            bufs.append(buf)
            return _return_info(f, stream, buf)
        infos = _both(run)
        assert infos == [(len(DATA), "", 1, 0)] * 2
        assert all(bytes(b)[:len(DATA)] == DATA for b in bufs)
    # too small a buffer reports an error instead of raising
    infos = _both(lambda f: _return_info(f, stream, bytearray(100)))
    assert infos[0][2] == ffi.BROTLI_DECODER_RESULT_ERROR and infos[0][1]
    assert infos[0][3] == -1
    # corrupt and truncated input
    bad = bytearray(stream)
    bad[40:60] = b"\xff" * 20
    for s in (bytes(bad), stream[:len(stream) // 2]):
        infos = _both(lambda f: _return_info(f, s, bytearray(len(DATA))))
        assert infos[0][2] == ffi.BROTLI_DECODER_RESULT_ERROR
        assert infos[0][3] == -2


def test_read_only_buffer_gives_the_error_result():
    """The preallocated decoders write into the caller's buffer: a
    read-only one (bytes) is refused, where the JAX package writes into
    the bytes object (ROADMAP queue 3)."""
    stream = _stream(5, data=DATA[:10_000])
    target = bytes(10_000)
    info = ffi.BrotliDecoderDecompressPrealloc(stream, target)
    assert (info.result, info.code) == (ffi.BROTLI_DECODER_RESULT_ERROR, -2)
    assert "read-only" in info.error
    assert target == bytes(10_000)
