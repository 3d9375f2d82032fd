"""The port's io wrappers (CompressorReader, CompressorWriter,
Decompressor, DecompressorWriter) against brotli_tpu's, on the CPU.

The same reads and writes go to both packages' wrappers over BytesIO
streams: every read returns the same bytes, and after every write,
flush, close and into_inner the wrapped stream holds the same bytes
(tolerance: none).  Compressed output decodes through libbrotlidec
(tests/oracle.py); the decompressors ignore bytes after the last
metablock and raise the same error on a truncated or corrupt stream.
"""

import io

import numpy as np
import pytest

import brotli_tpu
import brotli_tpu_torch
from . import oracle
from .test_torch_encoder import CUSTOM_DICTIONARY, phrases
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PACKAGES = (brotli_tpu, brotli_tpu_torch)
DATA = phrases(80_000, seed=81) + np.random.default_rng(82).integers(
    0, 256, 3_000, dtype=np.uint8).tobytes()
READS = [1, 100, 4096, 70_000, 3, -1, 10]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 -- compared by name
        return (type(e).__name__, str(e))


def _both(run):
    """run(pkg) for each package; the two results must be equal."""
    want, got = (run(pkg) for pkg in PACKAGES)
    assert got == want
    return got


@pytest.mark.parametrize("quality", [1, 5, 11])
def test_compressor_reader_matches_jax(quality):
    def run(pkg):
        r = pkg.CompressorReader(io.BytesIO(DATA), quality=quality,
                                 chunk_size=16 << 10)
        assert r.readable()
        return [r.read(n) for n in READS] + [r.read(), r.read(5)]
    reads = _both(run)
    assert reads[-2:] == [b"", b""]
    assert oracle.decompress(b"".join(reads),
                             max_size_hint=len(DATA)) == DATA


@pytest.mark.parametrize("params", [
    dict(quality=5), dict(quality=9, lgwin=16, chunk_size=8 << 10),
    dict(quality=11, catable=True), dict(quality=5, byte_align=True),
    dict(quality=5, custom_dictionary=CUSTOM_DICTIONARY)])
def test_compressor_writer_matches_jax(params):
    def run(pkg):
        raw = io.BytesIO()
        w = pkg.CompressorWriter(raw, **params)
        assert w.writable()
        seen = []
        for k, at in enumerate(range(0, len(DATA), 12_000)):
            assert w.write(DATA[at:at + 12_000]) == len(DATA[at:at + 12_000])
            if k in (2, 5):
                w.flush()
            seen.append(raw.getvalue())
        inner = w.into_inner()
        assert inner is raw and w.closed and not raw.closed
        w.close()
        w.flush()
        seen.append(raw.getvalue())
        return seen
    seen = _both(run)
    stream = seen[-1]
    d = brotli_tpu_torch.StreamDecoder(
        custom_dictionary=params.get("custom_dictionary", b""))
    assert d.decompress(stream) + d.finish() == DATA
    if "custom_dictionary" not in params:
        assert oracle.decompress(stream, max_size_hint=len(DATA)) == DATA


def test_compressor_writer_flushes_a_raw_stream_without_flush():
    class Sink:
        def __init__(self):
            self.parts = []

        def write(self, b):
            self.parts.append(bytes(b))

    def run(pkg):
        sink = Sink()
        w = pkg.CompressorWriter(sink, quality=5, chunk_size=4096)
        w.write(DATA[:10_000])
        w.flush()
        w.write(DATA[10_000:12_000])
        w.close()
        return sink.parts
    assert oracle.decompress(b"".join(_both(run))) == DATA[:12_000]


def _stream(quality=9):
    return oracle.compress(DATA, quality=quality, lgwin=18)


@pytest.mark.parametrize("quality", [1, 9, 11])
def test_decompressor_matches_jax(quality):
    stream = _stream(quality)
    reads = _both(lambda pkg: [
        r.read(n) for r in [pkg.Decompressor(io.BytesIO(stream))]
        for n in READS + [-1, 7]])
    assert b"".join(reads) == DATA
    # bytes after the last metablock are ignored
    reads = _both(lambda pkg: pkg.Decompressor(
        io.BytesIO(stream + b"trailing garbage")).read())
    assert reads == DATA


def test_decompressor_errors_match_jax():
    stream = _stream()
    for bad in (stream[:len(stream) // 2], stream[:-1],
                stream[:100] + bytes(b ^ 0x5A for b in stream[100:140])
                + stream[140:]):
        def run(pkg):
            r = pkg.Decompressor(io.BytesIO(bad))
            return [_outcome(lambda: r.read(50_000)) for _ in range(5)]
        outcomes = _both(run)
        assert any(isinstance(o, tuple) for o in outcomes)


@pytest.mark.parametrize("step", [1_000, 65_536])
def test_decompressor_writer_matches_jax(step):
    stream = oracle.compress(DATA, quality=5, lgwin=18)

    def run(pkg):
        raw = io.BytesIO()
        w = pkg.DecompressorWriter(raw)
        assert w.writable()
        seen = []
        for at in range(0, len(stream), step):
            assert w.write(stream[at:at + step]) == len(
                stream[at:at + step])
            seen.append(raw.getvalue())
        inner = w.into_inner()
        assert inner is raw and w.closed
        w.close()
        seen.append(raw.getvalue())
        return seen
    assert _both(run)[-1] == DATA


def test_decompressor_writer_custom_dictionary_and_error_match_jax():
    data = DATA[:20_000]
    stream = brotli_tpu.compress(data, quality=9,
                                 custom_dictionary=CUSTOM_DICTIONARY)

    def run(pkg):
        raw = io.BytesIO()
        w = pkg.DecompressorWriter(raw, custom_dictionary=CUSTOM_DICTIONARY)
        w.write(stream)
        return w.into_inner().getvalue()
    assert _both(run) == data

    def corrupt(pkg):
        w = pkg.DecompressorWriter(io.BytesIO())
        return [_outcome(lambda: w.write(b"\x1b" + b"\xff" * 40))
                for _ in range(3)]
    outcomes = _both(corrupt)
    assert all(isinstance(o, tuple) for o in outcomes)
