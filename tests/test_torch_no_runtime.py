"""The port's no-runtime mode on the host against the JAX package's, on
the CPU.

With BROTLI_TPU_TORCH_NO_NATIVE set the port builds and loads nothing
under native/, available() is false and get_lib() raises; the tests
also patch get_lib to raise, so an unguarded binding fails the test.
The JAX package is put in its own no-runtime mode as
tests/test_native.py does (_lib None, _tried True).  Each module's
Python route equals the JAX package's at tolerance 0 (arrays equal
with equal dtypes, streams byte for byte): the numpy bit packer, the
resolve walk, the numpy match finder and the greedy walk, the numpy
dictionary index and collectors, the optimal parser's literal costs,
collection, edge list and DP; then compress at q0-q11 under the stream
flags, the Compressor and compress_multi.  Where the JAX package's own
tests hold its Python routes against its runtime, the port's Python
routes are held against the port's runtime: resolve_commands command
for command, collect_dict_matches as sets, pack_bits word for word
(tests/test_torch_dict_index.py holds the numpy sorted_dict_index,
which needs the Python-built transform index that file builds).  Every
stream decodes through libbrotlidec.  Inputs: seeded phrases and RFC
dictionary slices of 4-16 KiB.
"""

import dataclasses

import numpy as np
import pytest

import brotli_tpu
from brotli_tpu import native_bridge as jnb
from brotli_tpu.encode import bitstream as JB
from brotli_tpu.encode import command as JC
from brotli_tpu.encode import match as JMT
from brotli_tpu.encode import static_dict as JS
from brotli_tpu.encode import zopfli as JZ
from brotli_tpu.encode.params import EncoderParams as JParams
import brotli_tpu_torch
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.encode import bitstream as B
from brotli_tpu_torch.encode import command as CM
from brotli_tpu_torch.encode import match as MT
from brotli_tpu_torch.encode import static_dict as S
from brotli_tpu_torch.encode import zopfli as Z
from brotli_tpu_torch.encode.params import EncoderParams
from .test_torch_encoder import (CUSTOM_DICTIONARY, PREFIX, after_prefix,
                                 decodes, dictionary_slice, phrases)
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TEXT = phrases(12_000, seed=81) + dictionary_slice(20_000, 24_000)
BINARY = (np.random.default_rng(82).integers(0, 256, 3_000, dtype=np.uint8)
          .tobytes() + bytes(range(256)) * 8 + phrases(3_000, seed=83))
DIST = EncoderParams(quality=5).sanitize(None).dist


def _unguarded(*args, **kwargs):
    raise AssertionError("a native binding was reached in the no-runtime "
                         "mode")


@pytest.fixture
def no_runtime(monkeypatch):
    """Both packages without their runtime; the port's get_lib raises."""
    monkeypatch.setattr(jnb, "_lib", None)
    monkeypatch.setattr(jnb, "_tried", True)
    monkeypatch.setenv(nb.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(nb, "get_lib", _unguarded)
    assert not jnb.available() and not nb.available()


def _same(got, want):
    """Equal arrays of equal dtypes, element by element of a tuple."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def _arr(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


# --- the switch ----------------------------------------------------------

def test_switch_builds_nothing_and_get_lib_raises(monkeypatch):
    monkeypatch.setattr(nb, "_lib", None)
    monkeypatch.setattr(nb, "build", _unguarded)
    for value in ("1", "yes"):
        monkeypatch.setenv(nb.NO_NATIVE_ENV, value)
        assert nb.switched_off() and not nb.available()
        with pytest.raises(RuntimeError, match=nb.NO_NATIVE_ENV):
            nb.get_lib()
        with pytest.raises(RuntimeError):
            nb.pack_bits(np.ones(2, np.uint64), np.ones(2, np.int64))
    assert nb._lib is None
    for value in ("", "0"):
        monkeypatch.setenv(nb.NO_NATIVE_ENV, value)
        assert not nb.switched_off()


def test_failed_build_leaves_available_false(monkeypatch):
    def failing_build():
        raise RuntimeError("native build failed")
    monkeypatch.delenv(nb.NO_NATIVE_ENV, raising=False)
    monkeypatch.setattr(nb, "_lib", None)
    monkeypatch.setattr(nb, "_build_error", None)
    monkeypatch.setattr(nb, "build", failing_build)
    with pytest.warns(RuntimeWarning, match="pure-Python routes"):
        assert not nb.available()
    assert not nb.available()  # remembered: no second build
    with pytest.raises(RuntimeError, match="did not build"):
        nb.get_lib()
    data = TEXT[:6_000]
    out = brotli_tpu_torch.compress(data, quality=5)
    decodes(out, data)


# --- bitstream.pack_bits --------------------------------------------------

def _bit_items(seed: int, n: int = 4_000):
    """Items of 0-31 bits, zero-bit items and a trailing one among them."""
    rng = np.random.default_rng(seed)
    nbits = rng.integers(0, 32, n).astype(np.int64)
    nbits[rng.random(n) < 0.1] = 0
    nbits[-1] = 0
    bits = (rng.integers(0, 1 << 31, n) & ((1 << nbits) - 1)).astype(
        np.uint64)
    return bits, nbits


@pytest.mark.parametrize("seed", [1, 2])
def test_pack_bits_numpy_matches_jax_and_native(seed, monkeypatch):
    bits, nbits = _bit_items(seed)
    native = B.pack_bits(bits, nbits)
    monkeypatch.setenv(nb.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(nb, "get_lib", _unguarded)
    monkeypatch.setattr(jnb, "_lib", None)
    monkeypatch.setattr(jnb, "_tried", True)
    got = B.pack_bits(bits, nbits)
    _same(got[0], JB.pack_bits(bits, nbits)[0])
    assert got[1] == JB.pack_bits(bits, nbits)[1] == native[1]
    _same(got[0], native[0])
    _same(B.pack_bits(bits[:0], nbits[:0])[0],
          JB.pack_bits(bits[:0], nbits[:0])[0])


# --- command.resolve_commands ---------------------------------------------

def _raw_commands(seed: int, n: int = 600):
    """Raw (insert, copy, distance) triples that hit every short code,
    direct codes, long codes, dictionary references past max_distance
    and a trailing insert-only command."""
    rng = np.random.default_rng(seed)
    ins = rng.integers(0, 40, n)
    cps = rng.integers(2, 80, n)
    dist = rng.integers(1, 20_000, n)
    reuse = rng.random(n) < 0.4
    for i in np.nonzero(reuse)[0]:
        if i >= 2:
            dist[i] = dist[i - rng.integers(1, 3)] + rng.integers(-3, 4)
    dist = np.maximum(dist, 1)
    dist[rng.random(n) < 0.05] = 1 << 23   # beyond max_distance
    ins[-1], cps[-1], dist[-1] = 17, 0, 0
    return ins, cps, dist


@pytest.mark.parametrize("npostfix,ndirect", [(0, 0), (1, 12), (2, 40)])
def test_resolve_commands_matches_jax_and_native(npostfix, ndirect,
                                                 monkeypatch):
    ins, cps, dist = _raw_commands(npostfix + 3)
    adv = cps.copy()
    adv[:5] = np.maximum(cps[:5] - 1, 0)
    dp = dataclasses.replace(DIST, npostfix=npostfix, ndirect=ndirect)
    kw = dict(advance=adv, initial_cache=[4, 11, 15, 16], pos_offset=300,
              window_size=(1 << 22) - 16)
    native, ncache = CM.resolve_commands(ins, cps, dist, dp, **kw)
    monkeypatch.setenv(nb.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(nb, "get_lib", _unguarded)
    monkeypatch.setattr(jnb, "_lib", None)
    monkeypatch.setattr(jnb, "_tried", True)
    got, cache = CM.resolve_commands(ins, cps, dist, dp, **kw)
    want, wcache = JC.resolve_commands(ins, cps, dist, dp, **kw)
    assert cache == wcache == ncache
    fields = ("insert_len", "copy_len", "distance", "dist_code",
              "dist_extra", "dist_extra_bits", "cmd_sym", "copy_advance")
    for f in fields:
        _same(getattr(got, f), getattr(want, f))
        _same(getattr(got, f), getattr(native, f))
    assert CM.compute_distance_code(7, 100, [4, 11, 15, 16]) == \
        JC.compute_distance_code(7, 100, [4, 11, 15, 16])


# --- match: the numpy finder and the greedy walk --------------------------

KNOBS = {
    "q1": dict(k=1, bucket_bits=15, k8=0),
    "q3_hash5": dict(k=2, bucket_bits=16, k8=0, hash_len=5),
    "q5": dict(k=7, bucket_bits=16, k8=2, bucket_bits8=16, hash_len=4),
    "q9": dict(k=24, bucket_bits=17, k8=8, bucket_bits8=16, hash_len=4),
}


@pytest.mark.parametrize("dict_len", [0, 2_000])
@pytest.mark.parametrize("knobs", KNOBS)
def test_find_best_matches_and_greedy_parse_match_jax(knobs, dict_len,
                                                      no_runtime):
    data = _arr(TEXT[:8_000] + BINARY[:2_000])
    kw = dict(dict_len=dict_len, literal_byte_score=540,
              use_dictionary=True, **KNOBS[knobs])
    got = MT.find_best_matches(data, (1 << 18) - 16, **kw)
    want = JMT.find_best_matches(data, (1 << 18) - 16, **kw)
    _same(got, want)
    bl, bd, bs_, isd, bw = got
    n = len(data) - dict_len
    bounds = [2_500, 6_000, n]
    args = (data, bl, bd, bs_, bounds)
    pkw = dict(dict_len=dict_len, pos0=5, initial_cache=(4, 11, 15, 16),
               best_isdict=isd, window_size=(1 << 18) - 16, best_wire=bw)
    segs = MT.greedy_parse(*args, **pkw)
    assert segs == JMT.greedy_parse_py(*args, **pkw)
    assert sum(len(s[0]) for s in segs) > 100


def test_match_helpers_match_jax(no_runtime):
    data = _arr(BINARY)
    for bits in (14, 17):
        _same(MT.hash_positions(data, bits), JMT.hash_positions(data, bits))
        _same(MT.hash_positions5(data, bits),
              JMT.hash_positions5(data, bits))
        _same(MT.hash_positions_u64(data, bits),
              JMT.hash_positions_u64(data, bits))
    h = MT.hash_positions(data, 12)
    _same(MT.topk_candidates(h, 5), JMT.topk_candidates(h, 5))
    rng = np.random.default_rng(5)
    b = rng.integers(64, len(data), 500)
    a = b - rng.integers(1, 64, 500)
    lim = len(data) - b
    _same(MT.match_lengths(data, a, b, lim),
          JMT.match_lengths(data, a, b, lim))
    assert MT._probe_len(data, 0, 300, 50) == JMT._probe_len(data, 0, 300,
                                                              50)
    assert [MT._cache_penalty(i) for i in range(16)] == \
        [JMT._cache_penalty(i) for i in range(16)]


# --- static_dict ----------------------------------------------------------

def test_collect_dict_matches_matches_jax_and_native(monkeypatch):
    data = _arr(PREFIX[:1_000] + dictionary_slice(60_000, 62_500))
    native = S.collect_dict_matches(data, 1_000, (1 << 22) - 16)
    JS.sorted_dict_index()  # the JAX index, built once before the switch
    monkeypatch.setenv(nb.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(nb, "get_lib", _unguarded)
    monkeypatch.setattr(jnb, "_lib", None)
    monkeypatch.setattr(jnb, "_tried", True)
    got = S.collect_dict_matches(data, 1_000, (1 << 22) - 16, chunk=1_500)
    _same(got, JS.collect_dict_matches(data, 1_000, (1 << 22) - 16,
                                       chunk=1_500))
    assert set(zip(*[a.tolist() for a in got])) == \
        set(zip(*[a.tolist() for a in native]))
    assert len(got[0]) > 1_000
    _same(S.collect_dict_matches_identity(data, 1_000, (1 << 22) - 16),
          JS.collect_dict_matches_identity(data, 1_000, (1 << 22) - 16))


# --- zopfli: the optimal parser's Python halves ---------------------------

@pytest.mark.parametrize("name", ["text", "binary", "utf8"])
def test_literal_costs_match_jax(name, no_runtime):
    data = {"text": TEXT[:9_000], "binary": BINARY,
            "utf8": ("été 中文 café " * 400)
            .encode()}[name]
    arr = _arr(data)
    _same(Z.estimate_literal_costs(arr), JZ.estimate_literal_costs(arr))
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 9, 2_000)
    lo = np.arange(2_000) - 40
    _same(Z._sliding_key_counts(keys, keys, lo, lo + 90),
          JZ._sliding_key_counts(keys, keys, lo, lo + 90))


ZOPFLI_CASES = {
    "q9_5": dict(quality=10, q9_5=True),
    "q10": dict(quality=10, q10_deep=True),
    "q11": dict(quality=11),
}


@pytest.mark.parametrize("case", ZOPFLI_CASES)
def test_zopfli_collect_and_segment_match_jax(case, no_runtime):
    full = _arr(PREFIX[:3_000] + TEXT[:7_000])
    p = EncoderParams(**ZOPFLI_CASES[case]).sanitize(len(full))
    jp = JParams(**ZOPFLI_CASES[case]).sanitize(len(full))
    iters = 1 if case == "q9_5" else None
    col = Z.zopfli_collect(full, p, 3_000, iters)
    jcol = JZ.zopfli_collect(full, jp, 3_000, iters)
    assert col.keys() == jcol.keys() and col["extra"] is jcol["extra"] \
        is None
    for k in ("cand_lens", "cand_dists", "cand_isdict", "cand_wire",
              "lit_costs"):
        _same(col[k], jcol[k])
    cache = (9, 4, 11, 15)
    got = Z.zopfli_segment(full, p, 3_000, cache, iters, precollected=col)
    assert got == JZ.zopfli_segment(full, jp, 3_000, cache, iters,
                                    precollected=jcol)
    prepared = Z._prepare_edges(col["cand_lens"], col["cand_dists"],
                                col["cand_isdict"], col["cand_wire"],
                                p.dist, len(full) - 3_000)
    jprep = JZ._prepare_edges(jcol["cand_lens"], jcol["cand_dists"],
                              jcol["cand_isdict"], jcol["cand_wire"],
                              jp.dist, len(full) - 3_000)
    _same(prepared, jprep)
    cost_dist = np.log2(20.0 + np.arange(p.dist.alphabet_size))
    _same(Z._price_edges(prepared, cost_dist),
          JZ._price_edges(jprep, cost_dist))


def test_zopfli_parse_and_finish_match_jax(no_runtime):
    full = _arr(TEXT[:6_000])
    p = EncoderParams(quality=11).sanitize(len(full))
    col = Z.zopfli_collect(full, p, 0)
    n = len(full)
    prepared = Z._prepare_edges(col["cand_lens"], col["cand_dists"],
                                col["cand_isdict"], col["cand_wire"],
                                p.dist, n)
    lcp = np.concatenate([[0.0], np.cumsum(col["lit_costs"])])
    cost_cmd = np.log2(11.0 + np.arange(704))
    cost_dist = np.log2(20.0 + np.arange(p.dist.alphabet_size))
    edges = Z._price_edges(prepared, cost_dist) + (
        cost_dist[:16], full, 0, p.window_size, np.array([4, 11, 15, 16]))
    got = Z.zopfli_parse(n, lcp, cost_cmd, edges)
    assert got == JZ.zopfli_parse(n, lcp, cost_cmd, edges)
    assert sum(got[0]) + sum(got[3]) == n and len(got[0]) > 50
    # the numpy close of _finish_parse on a DP's arrays
    cost = np.full(n + 1, 1e30)
    cost[0] = 0.0
    cost[n] = 9.0
    prev = [np.zeros(n + 1, np.int64) for _ in range(4)]
    prev[1][n] = n
    assert Z._finish_parse(n, lcp, cost, *prev) == \
        JZ._finish_parse(n, lcp, cost, *prev)


def test_collect_candidates_extension_matches_jax(no_runtime):
    """Runs longer than the search's cap extend in Python, each span
    once (the amortized skip)."""
    full = _arr(b"abcdefgh" * 45 + TEXT[:1_000] + b"xy" * 200)
    rows = Z._collect_candidates(full, (1 << 22) - 16, 0, 540, True)
    _same(rows, JZ._collect_candidates(full, (1 << 22) - 16, 0, 540, True))
    p = EncoderParams(quality=11).sanitize(len(full))
    col = Z.zopfli_collect(full, p, 0)
    jcol = JZ.zopfli_collect(full, JParams(quality=11).sanitize(len(full)),
                             0)
    _same(col["cand_lens"], jcol["cand_lens"])
    assert col["cand_lens"].max() > MT.MATCH_CAP


# --- the whole host slice -------------------------------------------------

FLAGS = {
    "plain": {},
    "catable": dict(catable=True),
    "appendable": dict(appendable=True),
    "byte_align": dict(byte_align=True),
    "large_window": dict(large_window=True, lgwin=26),
    "custom_dictionary": dict(custom_dictionary=CUSTOM_DICTIONARY[-8_000:]),
    "lgblock16": dict(lgblock=16),
    "stream_offset": dict(catable=True, bare=True,
                          stream_offset=len(PREFIX)),
}


def _check(data: bytes, quality: int, flags: dict) -> bytes:
    got = brotli_tpu_torch.compress(data, quality=quality, **flags)
    assert got == brotli_tpu.compress(data, quality=quality, **flags)
    if flags.get("stream_offset"):
        head = brotli_tpu_torch.compress(PREFIX, quality=5, appendable=True,
                                         byte_align=True)
        decodes(after_prefix(got, head), PREFIX + data)
    else:
        decodes(got, data, large_window=flags.get("large_window", False),
                dictionary=flags.get("custom_dictionary", b""))
    return got


@pytest.mark.parametrize("quality", range(12))
def test_compress_every_quality_matches_jax(quality, no_runtime):
    _check(TEXT[:4_000] + BINARY[:2_000], quality, {})


@pytest.mark.parametrize("flags", sorted(set(FLAGS) - {"plain"}))
@pytest.mark.parametrize("quality", [5, 11])
def test_compress_stream_flags_match_jax(quality, flags, no_runtime):
    """At q10 and above with stream_offset the bytes are the reference's
    (ROADMAP queue 3): no dictionary word is taken without the runtime's
    collector here, so the stream decodes."""
    _check(TEXT[:4_000], quality, FLAGS[flags])


@pytest.mark.parametrize("quality", [9, 10, 12])
def test_q9_5_tiers_match_jax(quality, no_runtime):
    _check(TEXT[:4_000], quality, dict(q9_5=True))


@pytest.mark.parametrize("quality", [1, 5, 11])
def test_compressor_matches_jax(quality, no_runtime):
    data = TEXT[:6_000]
    outs = []
    for pkg in (brotli_tpu, brotli_tpu_torch):
        c = pkg.Compressor(quality=quality, chunk_size=4 << 10)
        outs.append([c.process(data[:3_000]), c.flush(),
                     c.process(data[3_000:]), c.finish()])
    assert outs[0] == outs[1]
    decodes(b"".join(outs[1]), data)


@pytest.mark.parametrize("backend", ["thread", "workpool"])
def test_compress_multi_matches_jax(backend, no_runtime):
    data = TEXT[:16_384]
    got = brotli_tpu_torch.compress_multi(data, 3, quality=5,
                                          backend=backend)
    assert got == brotli_tpu.compress_multi(data, 3, quality=5,
                                            backend=backend)
    decodes(got, data)


def test_compress_multi_favor_cpu_efficiency_matches_jax(no_runtime):
    data = TEXT[:12_288]
    got = brotli_tpu_torch.compress_multi(data, 3, quality=7,
                                          favor_cpu_efficiency=True)
    assert got == brotli_tpu.compress_multi(data, 3, quality=7,
                                            favor_cpu_efficiency=True)
    decodes(got, data)


def test_decoders_and_ffi_take_the_switch(no_runtime):
    """decompress, decompress_batch and the FFI's decoder decode in
    Python; the FFI's preallocated encoder, the runtime's, returns
    None."""
    from brotli_tpu_torch import ffi
    data = TEXT[:5_000]
    stream = brotli_tpu.compress(data, quality=9)
    assert brotli_tpu_torch.decompress(stream) == data
    assert brotli_tpu_torch.decompress_batch([stream, stream]) == [data] * 2
    buf = bytearray(len(data))
    info = ffi.BrotliDecoderDecompressWithReturnInfo(stream, buf)
    assert info.result == ffi.BROTLI_DECODER_RESULT_SUCCESS
    assert bytes(buf[:info.decoded_size]) == data
    assert ffi.BrotliEncoderCompressPrealloc(5, 22, 0, data) is None
    assert ffi.BrotliEncoderCompress(5, 22, 0, data) == \
        brotli_tpu.compress(data, quality=5)
