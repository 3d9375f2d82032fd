"""The port's host encoder (brotli_tpu_torch.compress) against
brotli_tpu.compress, on the CPU.

Every case asserts equal bytes (tolerance: none) and decodes the port's
stream through the system libbrotlidec (tests/oracle.py); the streams
it cannot take alone are first made whole:
  - a large-window stream goes through its streaming API with
    BROTLI_DECODER_PARAM_LARGE_WINDOW set;
  - a stream with a custom dictionary is spliced after the dictionary
    stored as metablocks (the dictionary is the output before the
    stream's first byte, as it is to the encoder);
  - a bare or stream_offset part is appended to an appendable stream
    of the bytes before it and closed with the '11' byte.
Inputs are seeded phrases, random bytes, every byte value, the empty
input, 1-3 bytes and slices of the RFC dictionary, at q0-q9 under each
stream flag; then the metablock callback's IR, inputs of 2 MiB and more
(the dual-session parse), multi-metablock inputs at q1 and q3 with and
without the whole-stream native pipelines, the native store's refusals,
and the optimal-parser tiers on two small inputs
(tests/test_torch_zopfli.py has the rest).  tests/test_torch_multi.py
and tests/test_torch_zopfli.py take their inputs and decoding from
here.
"""

import ctypes
import dataclasses
import os

import numpy as np
import pytest

import brotli_tpu
from brotli_tpu.core.bitio import BitWriter as JaxBitWriter
from brotli_tpu import native_bridge as jnb
from brotli_tpu_torch import compress
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.concat.brocatli import parse_window_size
from brotli_tpu_torch.core.bitio import BitWriter
from brotli_tpu_torch.encode import bitstream as bs
from brotli_tpu_torch.encode import encoder as E
from brotli_tpu_torch.encode.command import resolve_commands
from brotli_tpu_torch.encode.params import DistanceParams
from . import oracle
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DICTIONARY = os.path.join(ROOT, "brotli_tpu", "data", "dictionary.bin")


def phrases(n: int, seed: int = 1, vocab_seed: int = 0) -> bytes:
    """Zipf-distributed words of a seeded vocabulary, with seeded
    random runs and repeated earlier runs between them."""
    vrng = np.random.default_rng(vocab_seed)
    words = [bytes(vrng.integers(97, 123, vrng.integers(2, 9),
                                 dtype=np.uint8)) for _ in range(400)]
    rng = np.random.default_rng(seed)
    parts, size = [], 0
    while size < n:
        if rng.random() < 0.1:
            part = rng.integers(0, 256, rng.integers(8, 64),
                                dtype=np.uint8).tobytes()
        elif rng.random() < 0.2 and parts:
            part = parts[int(rng.integers(0, len(parts)))]
        else:
            part = b" ".join(words[i] for i in
                             rng.zipf(1.3, 40) % len(words)) + b". "
        parts.append(part)
        size += len(part)
    return b"".join(parts)[:n]


def dictionary_slice(lo: int, hi: int) -> bytes:
    with open(DICTIONARY, "rb") as f:
        return f.read()[lo:hi]


def inputs() -> dict:
    """The named inputs every flag and quality runs on."""
    rng = np.random.default_rng(7)
    return {
        "empty": b"",
        "one_byte": rng.integers(0, 256, 1, dtype=np.uint8).tobytes(),
        "two_bytes": rng.integers(0, 256, 2, dtype=np.uint8).tobytes(),
        "three_bytes": rng.integers(0, 256, 3, dtype=np.uint8).tobytes(),
        "phrases": phrases(60_000),
        "random": rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
        "every_byte": bytes(range(256)) * 16 + bytes(range(255, -1, -1)),
        "dictionary_slice": dictionary_slice(30_000, 70_000),
    }


def low_entropy(n: int, seed: int = 5) -> bytes:
    """Seeded bytes of 180 symbols: about 7.5 bits a byte and almost no
    match, so a metablock is one long insert that the native store
    refuses for its buffer and still keeps under 8 bits a byte."""
    return np.random.default_rng(seed).integers(
        0, 180, n, dtype=np.uint8).tobytes()


def decode_large_window(stream: bytes, size: int) -> bytes:
    """libbrotlidec's streaming decode with large windows allowed."""
    _, dec = oracle._libs()
    dec.BrotliDecoderCreateInstance.restype = ctypes.c_void_p
    dec.BrotliDecoderCreateInstance.argtypes = [ctypes.c_void_p] * 3
    dec.BrotliDecoderSetParameter.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_uint32]
    dec.BrotliDecoderDestroyInstance.argtypes = [ctypes.c_void_p]
    dec.BrotliDecoderDecompressStream.restype = ctypes.c_int
    dec.BrotliDecoderDecompressStream.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    state = dec.BrotliDecoderCreateInstance(None, None, None)
    try:
        dec.BrotliDecoderSetParameter(state, 1, 1)  # LARGE_WINDOW
        src = ctypes.create_string_buffer(stream, len(stream))
        out = ctypes.create_string_buffer(size + 1)
        avail_in = ctypes.c_size_t(len(stream))
        next_in = ctypes.cast(src, ctypes.c_char_p)
        avail_out = ctypes.c_size_t(size + 1)
        next_out = ctypes.cast(out, ctypes.c_char_p)
        rc = dec.BrotliDecoderDecompressStream(
            state, ctypes.byref(avail_in), ctypes.byref(next_in),
            ctypes.byref(avail_out), ctypes.byref(next_out), None)
    finally:
        dec.BrotliDecoderDestroyInstance(state)
    if rc != 1:
        raise AssertionError(f"libbrotlidec large-window decode: {rc}")
    return out.raw[:size + 1 - avail_out.value]


def after_dictionary(stream: bytes, dictionary: bytes) -> bytes:
    """`stream` (made with custom_dictionary=dictionary) with the
    dictionary between its window header and its first metablock: all
    but its last k bytes stored raw, the last k as a compressed
    metablock of one insert, k chosen so that the stream's first
    metablock keeps its bit phase (its uncompressed metablocks pad to
    whole bytes from there)."""
    lgwin, header_bits = parse_window_size(stream)
    bits = np.unpackbits(np.frombuffer(stream, np.uint8),
                         bitorder="little")[header_bits:]
    padded = np.concatenate([bits, np.zeros(-len(bits) % 64, np.uint8)])
    params = DistanceParams()
    dic = np.frombuffer(dictionary, np.uint8)
    for k in range(1, min(len(dic), 256) + 1):
        w = BitWriter()
        bs.write_stream_header(w, lgwin)
        raw = dictionary[:len(dic) - k]
        for at in range(0, len(raw), 1 << 24):
            bs.store_uncompressed_meta_block(w, raw[at:at + (1 << 24)])
        cmds, _ = resolve_commands([k], [0], [0], params)
        bs.store_meta_block_trivial(w, dic, len(dic) - k, k, False, cmds,
                                    params)
        if w.bit_length() % 8 == header_bits % 8:
            w.append_packed(np.packbits(padded, bitorder="little")
                            .view("<u8"), len(bits))
            return w.getvalue()
    raise AssertionError("after_dictionary: no k keeps the bit phase")


def after_prefix(part: bytes, prefix_stream: bytes) -> bytes:
    """A bare or stream_offset part behind the appendable, byte-aligned
    stream of the bytes before it (its '11' byte dropped), closed with
    the '11' byte."""
    assert prefix_stream.endswith(b"\x03")
    return prefix_stream[:-1] + part + b"\x03"


def decodes(stream: bytes, data: bytes, large_window: bool = False,
            dictionary: bytes = b"") -> None:
    """Assert that libbrotlidec gives `data` back from `stream`."""
    if large_window:
        assert decode_large_window(stream, len(data)) == data
        return
    if dictionary:
        got = oracle.decompress(after_dictionary(stream, dictionary),
                                max_size_hint=len(dictionary) + len(data))
        assert got == dictionary + data
        return
    assert oracle.decompress(stream, max_size_hint=len(data) + 1) == data


# the bytes before a bare or stream_offset part, and a custom dictionary
# that shares the phrases' vocabulary
PREFIX = phrases(5_000, seed=11)
CUSTOM_DICTIONARY = phrases(30_000, seed=12) + dictionary_slice(0, 4_000)

FLAGS = {
    "plain": {},
    "catable": dict(catable=True),
    "appendable": dict(appendable=True),
    "bare_catable": dict(bare=True, catable=True),
    "byte_align": dict(byte_align=True),
    "magic_number": dict(magic_number=True),
    "large_window": dict(large_window=True, lgwin=26),
    "lgwin10": dict(lgwin=10),
    "lgwin16": dict(lgwin=16),
    "lgwin24": dict(lgwin=24),
    "lgblock16": dict(lgblock=16),
    "custom_dictionary": dict(custom_dictionary=CUSTOM_DICTIONARY),
    "no_context_modeling": dict(disable_literal_context_modeling=True),
    "stream_offset": dict(catable=True, bare=True,
                          stream_offset=len(PREFIX)),
}


@pytest.fixture(scope="module")
def named_inputs():
    return inputs()


def _check(data: bytes, quality: int, flags: dict) -> bytes:
    """The port's stream: equal to the JAX package's, and decoded back."""
    got = compress(data, quality=quality, **flags)
    assert got == brotli_tpu.compress(data, quality=quality, **flags)
    if flags.get("bare") or flags.get("stream_offset"):
        head = compress(PREFIX, quality=5, appendable=True, byte_align=True)
        decodes(after_prefix(got, head), PREFIX + data)
    else:
        decodes(got, data, large_window=flags.get("large_window", False),
                dictionary=flags.get("custom_dictionary", b""))
    return got


def _refuse_whole_stream_pipelines(monkeypatch, *modules):
    for mod in modules:
        monkeypatch.setattr(mod, "compress_fragment_pipeline",
                            lambda *a, **k: None)
        monkeypatch.setattr(mod, "compress_session_pipeline",
                            lambda *a, **k: None)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("quality", range(10))
def test_compress_matches_jax(named_inputs, quality, flags, monkeypatch):
    """Below q4 a large-window stream takes the per-metablock route in
    the port (test_large_window_below_q4_decodes): it equals the JAX
    package's stream on that route."""
    if flags == "large_window" and quality < 4:
        _refuse_whole_stream_pipelines(monkeypatch, jnb)
    for name, data in named_inputs.items():
        _check(data, quality, FLAGS[flags])


@pytest.mark.parametrize("quality", range(4))
def test_large_window_below_q4_decodes(named_inputs, quality):
    """The JAX package sends a large-window stream below q4 to the
    whole-stream native pipelines, which write distance trees for the
    RFC window's alphabet: on every byte value its stream does not
    decode.  The port's does."""
    data = named_inputs["every_byte"]
    flags = FLAGS["large_window"]
    want = brotli_tpu.compress(data, quality=quality, **flags)
    with pytest.raises(AssertionError, match="large-window decode"):
        decodes(want, data, large_window=True)
    decodes(compress(data, quality=quality, **flags), data,
            large_window=True)


def _ir(commands) -> list:
    return [(type(c).__name__, dataclasses.asdict(c)) for c in commands]


@pytest.mark.parametrize("with_probabilities", [False, True])
@pytest.mark.parametrize("quality", range(10))
def test_metablock_callback_ir_matches_jax(quality, with_probabilities):
    """The IR lists and blocks handed to the callback, and the stream,
    equal the JAX package's, over metablocks of 64 KiB."""
    data = (dictionary_slice(0, 20_000) + phrases(150_000, seed=3)
            + dictionary_slice(20_000, 40_000))
    probs = None
    if with_probabilities:
        probs = np.random.default_rng(2).integers(
            0, 256, len(data), dtype=np.uint8).tobytes()
    seen = {"port": [], "jax": []}
    outs = {}
    for key, fn in (("port", compress), ("jax", brotli_tpu.compress)):
        outs[key] = fn(data, quality=quality, lgblock=16,
                       literal_probabilities=probs,
                       metablock_callback=lambda ir, block, key=key:
                       seen[key].append((ir, block)))
    assert outs["port"] == outs["jax"]
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for (ir_a, block_a), (ir_b, block_b) in zip(seen["port"], seen["jax"]):
        assert block_a == block_b
        assert _ir(ir_a) == _ir(ir_b)
    records = [c for ir, _ in seen["port"] for c in ir]
    kinds = {type(c).__name__ for c in records}
    assert {"Literal", "Copy"} <= kinds
    if quality >= 2:
        assert "Dict" in kinds
    lits = [c for c in records if type(c).__name__ == "Literal"]
    assert all((c.probs is not None) == with_probabilities for c in lits)
    assert b"".join(block for _, block in seen["port"]) == data
    decodes(outs["port"], data)


@pytest.mark.parametrize("quality", [5, 9])
def test_two_mib_input_takes_the_dual_parse_like_jax(quality, monkeypatch):
    data = phrases((2 << 20) + 4_321, seed=4)
    calls = []
    real = E._dual_parse_segments

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(E, "_dual_parse_segments", counted)
    _check(data, quality, {})
    assert calls == [1]


@pytest.mark.parametrize("whole_pipeline", [True, False])
@pytest.mark.parametrize("lgblock", [0, 16])
@pytest.mark.parametrize("quality", [1, 3])
def test_multi_metablock_low_tiers_match_jax(quality, lgblock,
                                             whole_pipeline, monkeypatch):
    """q1 and q3 over many metablocks: through the whole-stream native
    pipeline, and (both packages' pipelines refusing) through the
    per-metablock segments and the fused store."""
    if not whole_pipeline:
        _refuse_whole_stream_pipelines(monkeypatch, nb, jnb)
    data = phrases(1_200_000, seed=5)
    _check(data, quality, dict(lgblock=lgblock))
    _check(data, quality, dict(lgblock=lgblock, byte_align=True))


def count_planner_calls(monkeypatch) -> list:
    """Log each call of the port's pure-Python metablock planner."""
    from brotli_tpu_torch.encode import metablock as M
    calls = []
    real = M.build_meta_block

    def logged(*args, **kw):
        calls.append(args[2])  # mlen
        return real(*args, **kw)

    monkeypatch.setattr(M, "build_meta_block", logged)
    return calls


@pytest.mark.parametrize("quality", [4, 5, 9])
def test_refused_low_entropy_blocks_match_jax(quality, monkeypatch):
    """Metablocks of one long insert: the native store refuses them for
    its buffer, and both packages plan and store them through their
    pure-Python planners; both keep them compressed."""
    calls = []
    real = nb.store_metablock

    def logged(*args, cap_bits=None, **kw):
        res = real(*args, cap_bits=cap_bits, **kw)
        calls.append((cap_bits, res is None))
        return res

    monkeypatch.setattr(nb, "store_metablock", logged)
    planned = count_planner_calls(monkeypatch)
    data = low_entropy(300_000)
    got = _check(data, quality, dict(lgblock=16,
                                     metablock_callback=lambda *a: None))
    assert len(got) < len(data)
    assert (None, True) in calls
    assert all(cap is None for cap, _ in calls)
    assert len(planned) == sum(refused for _, refused in calls) > 0


def test_store_refusal_stores_the_block_uncompressed(monkeypatch):
    """Every native store refused, in both packages: each block goes
    through the pure-Python planner and stays compressed (no block is
    stored uncompressed), with the JAX package's bytes."""
    monkeypatch.setattr(nb, "store_metablock", lambda *a, **k: None)
    monkeypatch.setattr(jnb, "store_metablock", lambda *a, **k: None)
    planned = count_planner_calls(monkeypatch)
    data = phrases(150_000, seed=6)
    flags = dict(quality=5, lgblock=16, metablock_callback=lambda *a: None)
    out = compress(data, **flags)
    assert out == brotli_tpu.compress(data, **flags)
    assert planned == [1 << 16, 1 << 16, 150_000 - 2 * (1 << 16)]
    assert len(out) < len(data) // 2
    decodes(out, data)


@pytest.mark.parametrize("kw", [dict(), dict(quality=10), dict(quality=11),
                                dict(quality=12), dict(quality=9, q9_5=True),
                                dict(quality=10, q10_deep=True)])
def test_optimal_parser_tiers_raise(kw):
    """The optimal parser's tiers (the default quality 11 among them),
    which raised before the parser was ported: the port's stream now
    equals the JAX package's.  tests/test_torch_zopfli.py holds them
    on more inputs and flags."""
    flags = {k: v for k, v in kw.items() if k != "quality"}
    for data in (b"", b"hello brotli " * 100):
        _check(data, kw.get("quality", 11), flags)


def test_append_packed_phased_matches_jax():
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 63, 6, dtype=np.uint64)
    for phase in range(8):
        for nbits in (phase, phase + 1, 64, 200, 383):
            a, b = BitWriter(), JaxBitWriter()
            for w in (a, b):
                if phase:
                    w.write(0b1011011 & ((1 << phase) - 1), phase)
                masked = words.copy()
                masked[0] &= ~np.uint64((1 << phase) - 1)
                w.append_packed_phased(masked, nbits, phase)
            assert a.getvalue() == b.getvalue()
            assert (len(a), a.is_byte_aligned()) == (len(b),
                                                      b.is_byte_aligned())
    with pytest.raises(ValueError):
        BitWriter().append_packed_phased(words, 64, 3)
