"""The port's host decoders (Decoder, decompress, decompress_batch)
against brotli_tpu's, on the CPU.

Streams: libbrotlienc's at q0-q11 and lgwin 10-24; brotli_tpu.compress's
at q11 with a custom dictionary, a large window (lgwin 26), the magic
number and a bare part; metadata and empty metablocks written with the
port's BitWriter; q11 streams whose metablocks switch block types and
carry context maps.  On each, the port's Decoder and decompress return
what the JAX package's Decoder returns (tolerance: none), and where it
raises they raise the error of the same name: NeedsMoreInput for a
truncated stream, BrotliDecodeError for garbage and non-zero final
padding.  decompress_batch equals the JAX package's at 1 and 8 threads
and raises the first error after every stream joined.
"""

import numpy as np
import pytest

import brotli_tpu
from brotli_tpu.decode.batch import decompress_batch as j_decompress_batch
from brotli_tpu_torch import (BrotliDecodeError, Decoder, decompress,
                              decompress_batch)
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.core.bitio import BitWriter, NeedsMoreInput
from brotli_tpu_torch.decode import batch as B
from brotli_tpu_torch.decode import decoder as D
from brotli_tpu_torch.encode import bitstream as bs
from . import oracle
from .test_torch_encoder import (CUSTOM_DICTIONARY, PREFIX, after_prefix,
                                 dictionary_slice, phrases)
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = (phrases(9_000, seed=51) + dictionary_slice(1_000, 3_000)
        + np.random.default_rng(52).integers(0, 256, 1_000,
                                             dtype=np.uint8).tobytes())


def _outcome(fn, *args):
    """fn's output, or the name of the error it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 -- compared by name
        return type(e).__name__


def _same_as_jax(stream: bytes, custom_dictionary: bytes = b"",
                 large_window: bool = False):
    """The port's Decoder and decompress against the JAX Decoder;
    returns the outcome."""
    want = _outcome(brotli_tpu.Decoder(custom_dictionary,
                                       large_window).decompress, stream)
    assert _outcome(Decoder(custom_dictionary, large_window).decompress,
                    stream) == want
    assert _outcome(lambda s: decompress(s, custom_dictionary,
                                         large_window), stream) == want
    return want


@pytest.mark.parametrize("quality", range(12))
def test_libbrotlienc_streams_match_jax(quality):
    for lgwin in (10, 16, 22, 24):
        stream = oracle.compress(DATA, quality=quality, lgwin=lgwin)
        assert _same_as_jax(stream) == DATA


@pytest.mark.parametrize("flags", [
    dict(custom_dictionary=CUSTOM_DICTIONARY),
    dict(large_window=True, lgwin=26),
    dict(magic_number=True),
    dict(bare=True, catable=True)])
def test_brotli_tpu_q11_streams_match_jax(flags):
    data = phrases(30_000, seed=53)
    stream = brotli_tpu.compress(data, quality=11, **flags)
    cd = flags.get("custom_dictionary", b"")
    lw = flags.get("large_window", False)
    if flags.get("bare"):
        # alone it has no window header: both decoders read it alike
        _same_as_jax(stream)
        head = brotli_tpu.compress(PREFIX, quality=5, appendable=True,
                                   byte_align=True)
        stream, data = after_prefix(stream, head), PREFIX + data
    assert _same_as_jax(stream, cd, lw) == data
    if cd or lw:
        # without the dictionary or the large-window flag the stream
        # decodes wrong or not at all, the same way in both
        _same_as_jax(stream)


def _metadata(w: BitWriter, payload: bytes, last: bool = False):
    """A metadata metablock (RFC 7932 section 9.2): MNIBBLES 0, the
    reserved bit, MSKIPBYTES and MSKIPLEN - 1, then the payload at a
    byte boundary; ISLAST set where `last` (no ISLASTEMPTY follows)."""
    n = len(payload)
    w.write(int(last), 1)
    if last:
        w.write(0, 1)  # ISLASTEMPTY
    w.write(3, 2)
    w.write(0, 1)
    if n == 0:
        w.write(0, 2)
    else:
        nbytes = max(1, ((n - 1).bit_length() + 7) // 8)
        w.write(nbytes, 2)
        w.write(n - 1, 8 * nbytes)
    w.align_to_byte()
    w.write_bytes(payload)


def test_metadata_and_empty_metablocks_match_jax():
    rng = np.random.default_rng(54)
    data = phrases(5_000, seed=55)
    cases = []
    for sizes in ([0], [1], [300], [70_000], [0, 5, 256]):
        for last in (False, True):
            w = BitWriter()
            bs.write_stream_header(w, 22)
            for size in sizes:
                _metadata(w, rng.integers(0, 256, size,
                                          dtype=np.uint8).tobytes())
            if last:
                bs.store_uncompressed_meta_block(w, data)
                _metadata(w, b"tail", last=True)
                cases.append((w.getvalue(), data))
            else:
                bs.write_empty_last_meta_block(w)
                cases.append((w.getvalue(), b""))
    for lgwin in (10, 16, 17, 18, 24):
        w = BitWriter()
        bs.write_stream_header(w, lgwin)
        bs.write_empty_last_meta_block(w)
        cases.append((w.getvalue(), b""))
    for stream, want in cases:
        assert _same_as_jax(stream) == want
    # a set reserved bit in a metadata header
    w = BitWriter()
    bs.write_stream_header(w, 22)
    w.write(0b1110, 4)  # ISLAST 0, MNIBBLES 3, reserved 1
    w.align_to_byte()
    assert _same_as_jax(w.getvalue()) == "BrotliDecodeError"


def test_block_switches_and_context_maps_match_jax(monkeypatch):
    """A q11 stream of text, records and random bytes: its metablock
    switches block types and maps contexts to several trees."""
    rng = np.random.default_rng(56)
    data = b"".join([phrases(40_000, seed=57),
                     rng.integers(0, 256, 8_000, dtype=np.uint8).tobytes(),
                     bytes(range(256)) * 40,
                     phrases(20_000, seed=58, vocab_seed=3)])
    stream = brotli_tpu.compress(data, quality=11)
    headers = []
    real = D.Decoder._parse_metablock_header

    def spy(self, reader, mlen):
        headers.append(real(self, reader, mlen))
        return headers[-1]

    monkeypatch.setattr(D.Decoder, "_parse_metablock_header", spy)
    assert _same_as_jax(stream) == data
    types = [st.blocks[c].num_types for st in headers for c in "LID"]
    assert max(types) >= 2
    assert any(len(st.lit_decs) >= 2 or len(st.dist_decs) >= 2
               for st in headers)


def test_truncated_garbage_and_padding_errors_match_jax():
    stream = oracle.compress(DATA, quality=9)
    for cut in (1, len(stream) // 3, len(stream) // 2, len(stream) - 1):
        assert _same_as_jax(stream[:cut]) == "NeedsMoreInput"
    with pytest.raises(NeedsMoreInput):
        decompress(stream[:len(stream) // 2])
    assert _same_as_jax(b"\x13\x37" * 50) == "BrotliDecodeError"
    # ISLASTEMPTY with ones in the padding, and a flipped padding bit
    assert _same_as_jax(b"\xff") == "BrotliDecodeError"
    bad = bytearray(oracle.compress(DATA, quality=5))
    bad[-1] ^= 0x80
    assert _same_as_jax(bytes(bad)) == "BrotliDecodeError"
    with pytest.raises(BrotliDecodeError):
        decompress(bytes(bad))
    # trailing bytes after the aligned end are ignored
    assert _same_as_jax(stream + b"\x00junk") == DATA


def test_decompress_falls_back_to_decoder_without_the_runtime(
        monkeypatch):
    stream = brotli_tpu.compress(DATA, quality=11,
                                 custom_dictionary=CUSTOM_DICTIONARY)
    ran = []
    real = D.Decoder.decompress

    def spy(self, data, max_output=None):
        ran.append(1)
        return real(self, data, max_output)

    monkeypatch.setattr(D.Decoder, "decompress", spy)
    assert decompress(stream, CUSTOM_DICTIONARY) == DATA
    assert ran == []
    monkeypatch.setattr(nb, "available", lambda: False)
    assert decompress(stream, CUSTOM_DICTIONARY) == DATA
    assert decompress_batch([stream] * 2, CUSTOM_DICTIONARY) == [DATA] * 2
    assert ran == [1, 1, 1]


def _streams():
    rng = np.random.default_rng(59)
    datas = [phrases(int(rng.integers(0, 20_000)), seed=60 + k)
             for k in range(10)] + [b""]
    return [oracle.compress(d, quality=k % 12) for k, d in
            enumerate(datas)], datas


@pytest.mark.parametrize("threads", [1, 8])
def test_decompress_batch_matches_jax(threads):
    streams, datas = _streams()
    got = decompress_batch(streams, threads=threads)
    assert got == j_decompress_batch(streams, threads=threads) == datas
    hints = [len(d) for d in datas]
    assert decompress_batch(streams, threads=threads,
                            size_hints=hints) == datas
    cd = CUSTOM_DICTIONARY
    with_dict = [brotli_tpu.compress(d, quality=11, custom_dictionary=cd)
                 for d in datas[:3]]
    assert decompress_batch(with_dict, cd, threads=threads) == \
        j_decompress_batch(with_dict, cd, threads=threads) == datas[:3]
    lw = [brotli_tpu.compress(d, quality=11, large_window=True, lgwin=26)
          for d in datas[:3]]
    assert decompress_batch(lw, large_window=True, threads=threads) == \
        datas[:3]


@pytest.mark.parametrize("threads", [1, 8])
def test_decompress_batch_raises_first_error_after_join(threads,
                                                        monkeypatch):
    streams, datas = _streams()
    streams[3] = b"\x13\x37" * 50
    streams[6] = streams[6][:len(streams[6]) // 2]
    with pytest.raises(Exception) as jax_err:
        j_decompress_batch(streams, threads=threads)
    done = []
    real = B._decode_one

    def counted(stream, *args):
        out = real(stream, *args)
        done.append(stream)
        return out

    monkeypatch.setattr(B, "_decode_one", counted)
    with pytest.raises(BrotliDecodeError) as err:
        decompress_batch(streams, threads=threads)
    assert type(err.value).__name__ == type(jax_err.value).__name__
    # one thread stops at the first error; eight join every stream
    assert len(done) == (3 if threads == 1 else len(streams) - 2)
