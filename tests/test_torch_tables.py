"""The port's copied tables and host helpers against brotli_tpu's.

brotli_tpu_torch keeps its own copies of the fixed state the compress
path and the host decoders read: the dictionary, transforms and
context LUTs, the static dictionary index, the split parameters, the
per-tier knobs, the encoder-parameter rules, the format's code tables
and the Huffman cost helpers.  Each must equal the JAX package's.
"""

import dataclasses
import os

import numpy as np
import pytest

import brotli_tpu.core.constants as JC
import brotli_tpu.encode.metablock as JM
import brotli_tpu.encode.static_dict as JSD
from brotli_tpu import native_bridge as jnb
from brotli_tpu.core.dictionary import get_dictionary as jget_dict
from brotli_tpu.encode import bitstream as JB
from brotli_tpu.encode import tpu_path as JT
from brotli_tpu.encode.params import EncoderParams as JParams
from brotli_tpu.ops import matching as JMat
from brotli_tpu_torch import native_bridge as tnb
from brotli_tpu_torch.core import bitio as TBIO
from brotli_tpu_torch.core import constants as TC
from brotli_tpu_torch.core import huffman as THuf
from brotli_tpu_torch.core import prefix as TPre
from brotli_tpu_torch.core.dictionary import get_dictionary as tget_dict
from brotli_tpu_torch.encode import bitstream as TB
from brotli_tpu_torch.encode import command as TCmd
from brotli_tpu_torch.encode import gpu_path as TG
from brotli_tpu_torch.encode import metablock as TM
from brotli_tpu_torch.encode import static_dict as TSD
from brotli_tpu_torch.encode.params import DistanceParams as TDist
from brotli_tpu_torch.encode.params import from_reference
from brotli_tpu_torch.ops import matching as TMat
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["dictionary.bin", "dictionary_meta.npz",
                                  "transforms.npz", "context_lut.npy"])
def test_data_files_are_copies(name):
    a = open(os.path.join(ROOT, "brotli_tpu", "data", name), "rb").read()
    b = open(os.path.join(ROOT, "brotli_tpu_torch", "data", name),
             "rb").read()
    assert a == b


def test_constants_equal():
    assert TC.INITIAL_DISTANCE_CACHE == JC.INITIAL_DISTANCE_CACHE
    for name in ("CONTEXT_LSB6", "CONTEXT_MSB6", "CONTEXT_UTF8",
                 "CONTEXT_SIGNED", "MIN_DICTIONARY_WORD_LENGTH",
                 "MAX_DICTIONARY_WORD_LENGTH", "NUM_TRANSFORMS",
                 "LARGE_MAX_WINDOW_BITS"):
        assert getattr(TC, name) == getattr(JC, name), name
    np.testing.assert_array_equal(TC.CONTEXT_LUT0, JC.CONTEXT_LUT0)
    np.testing.assert_array_equal(TC.CONTEXT_LUT1, JC.CONTEXT_LUT1)
    for lgwin in range(10, 25):
        assert TC.encode_window_bits(lgwin) == JC.encode_window_bits(lgwin)
    for lgwin in range(10, 31):
        assert TC.encode_window_bits(lgwin, True) == \
            JC.encode_window_bits(lgwin, True)
    assert TMat.DISTANCE_BIT_PENALTY == JMat.DISTANCE_BIT_PENALTY
    assert TMat.MIN_SCORE_DELTA == JMat.MIN_SCORE_DELTA


def test_decoder_and_parser_constants_equal():
    """What the host Decoder and the optimal parser read: block length
    codes, command symbols, distance symbols and contexts."""
    for name in ("NUM_BLOCK_LEN_SYMBOLS", "MIN_WINDOW_BITS"):
        assert getattr(TC, name) == getattr(JC, name), name
    np.testing.assert_array_equal(TC.BLOCK_LEN_BASE, JC.BLOCK_LEN_BASE)
    np.testing.assert_array_equal(TC.BLOCK_LEN_EXTRA, JC.BLOCK_LEN_EXTRA)
    ins, cp, last = np.meshgrid(np.arange(24), np.arange(24), [0, 1])
    np.testing.assert_array_equal(
        TC.combine_length_codes(ins, cp, last.astype(bool)),
        JC.combine_length_codes(ins, cp, last.astype(bool)))
    cl = np.arange(0, 40)
    np.testing.assert_array_equal(TC.distance_context_from_copy_len(cl),
                                  JC.distance_context_from_copy_len(cl))
    dist = np.concatenate([np.arange(1, 5000), np.random.default_rng(
        10).integers(1, 1 << 30, 5000)])
    for npostfix in range(4):
        for ndirect in (0, 4 << npostfix, 15 << npostfix):
            far = dist[dist > ndirect]
            got = TC.encode_distance(far, npostfix, ndirect)
            for a, b in zip(got, JC.encode_distance(far, npostfix,
                                                    ndirect)):
                np.testing.assert_array_equal(a, b)
            sym, extra, _ = got
            np.testing.assert_array_equal(
                TC.num_distance_extra_bits(sym, npostfix, ndirect),
                JC.num_distance_extra_bits(sym, npostfix, ndirect))
            np.testing.assert_array_equal(
                TC.decode_distance(sym, npostfix, ndirect, extra), far)


def test_huffman_stream_cost_helpers_equal():
    import brotli_tpu.core.huffman as JHuf
    rng = np.random.default_rng(11)
    for size in (16, 40, 64, 200, 704):
        for zeros in (0.0, 0.3, 0.8):
            h = rng.integers(1, 500, size) * (rng.random(size) >= zeros)
            got = THuf.optimize_counts_for_rle(h)
            np.testing.assert_array_equal(got,
                                          JHuf.optimize_counts_for_rle(h))
            if h.sum():
                lengths = THuf.build_huffman_lengths(got)
                assert THuf.code_bit_cost(h, lengths) == \
                    JHuf.code_bit_cost(h, lengths)


def test_dictionary_equal():
    a, b = tget_dict(), jget_dict()
    assert a.data == b.data
    np.testing.assert_array_equal(a.offsets_by_length, b.offsets_by_length)
    np.testing.assert_array_equal(a.size_bits_by_length,
                                  b.size_bits_by_length)
    assert a.t_prefix == b.t_prefix
    assert a.t_suffix == b.t_suffix
    assert a.t_type == b.t_type
    for length in range(0, 30):
        assert a.num_words(length) == b.num_words(length)
    rng = np.random.default_rng(12)
    for length in range(4, 25):
        for word_id in rng.integers(0, 121 << 10, 40).tolist():
            try:
                want = b.resolve(length, word_id)
            except ValueError:
                with pytest.raises(ValueError):
                    a.resolve(length, word_id)
                continue
            assert a.resolve(length, word_id) == want
    with pytest.raises(ValueError):
        a.resolve(3, 0)


def test_static_dict_index_equal():
    for x, y in zip(TSD.dict_index(), JSD.dict_index()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(TSD.omit_last_transform_ids(),
                                  JSD.omit_last_transform_ids())


def test_add_dictionary_matches_equal():
    rng = np.random.default_rng(9)
    d = tget_dict()
    words = [d.data[o:o + 8] for o in rng.integers(0, 100000, 400)]
    text = np.frombuffer(b" ".join(words), np.uint8)
    n = len(text)
    outs = []
    for fn in (TSD.add_dictionary_matches, JSD.add_dictionary_matches):
        arrs = [np.zeros(n, np.int64), np.zeros(n, np.int64),
                np.full(n, 150, np.int64), np.zeros(n, bool),
                np.zeros(n, np.int64)]
        fn(text, 100, 1 << 16, 135, *arrs)
        outs.append(arrs)
    assert outs[0][3].any()
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)


def test_split_and_context_tables_equal():
    assert TM.SPLIT_PARAMS == JM.SPLIT_PARAMS
    assert TM.MIN_LENGTH_FOR_SPLITTING == JM.MIN_LENGTH_FOR_SPLITTING
    for name in ("STATIC_CONTEXT_MAP_CONTINUATION",
                 "STATIC_CONTEXT_MAP_SIMPLE_UTF8",
                 "STATIC_CONTEXT_MAP_COMPLEX_UTF8"):
        np.testing.assert_array_equal(getattr(TM, name), getattr(JM, name))


@pytest.mark.parametrize("seed", range(4))
def test_metablock_helpers_equal(seed):
    rng = np.random.default_rng(seed)
    text = np.frombuffer(b" ".join(
        bytes(rng.integers(97, 123, size=int(rng.integers(1, 8)),
                           dtype=np.uint8)) for _ in range(40000)),
        np.uint8)
    mixed = np.concatenate([text[:150000], rng.integers(
        0, 256, size=20000 * seed, dtype=np.uint8)])
    for data in (text, mixed):
        for q in (4, 5, 7, 9):
            assert TM.choose_context_mode(data, q, 0) == \
                JM.choose_context_mode(data, q, 0)
            for hint in (1000, 1 << 21):
                a = TM.choose_literal_context_map(data, 10, len(data) - 10,
                                                  q, hint)
                b = JM.choose_literal_context_map(data, 10, len(data) - 10,
                                                  q, hint)
                assert a[0] == b[0]
                np.testing.assert_array_equal(a[1], b[1])
    assign = rng.integers(0, 6, size=300)
    cost = rng.random((300, 6))
    np.testing.assert_array_equal(TM._hysteresis(assign, cost, 3),
                                  JM._hysteresis(assign, cost, 3))
    hist = rng.integers(0, 20, size=(300, 256)).astype(np.float64)
    np.testing.assert_array_equal(
        TM._merge_types(assign, hist, 6, 28.1, 320.0),
        JM._merge_types(assign, hist, 6, 28.1, 320.0))
    assert TM._runs(assign) == JM._runs(assign)


@pytest.mark.parametrize("quality", range(0, 13))
def test_device_knobs_and_params_equal(quality):
    if 2 <= quality <= 9:
        assert TG._device_knobs(quality) == JT._device_knobs(quality)
    for lgwin in (10, 16, 22, 24, 30):
        for size in (None, 0, 1, 5000, 1 << 20, 1 << 26):
            for mode in (0, 1, 2):
                ref = JParams(quality=quality, lgwin=lgwin, mode=mode)
                port = from_reference(dataclasses.asdict(ref))
                a = port.sanitize(size)
                b = ref.sanitize(size)
                for f in dataclasses.fields(a):
                    if f.name == "dist":
                        assert dataclasses.asdict(a.dist) == \
                            dataclasses.asdict(b.dist)
                    else:
                        assert getattr(a, f.name) == getattr(b, f.name)
                assert a.window_size == b.window_size
                assert a.dist.alphabet_size == b.dist.alphabet_size


def test_from_reference_rejects_unsupported_settings():
    ref = dataclasses.asdict(JParams(quality=9, q9_5=True))
    with pytest.raises(ValueError, match="q9_5"):
        from_reference(ref)
    with pytest.raises(ValueError, match="unknown"):
        from_reference(dict(dataclasses.asdict(JParams()), bogus=1))
    port = from_reference(dataclasses.asdict(JParams(
        quality=7, lgwin=18, catable=True, large_window=True)))
    assert (port.quality, port.lgwin, port.catable, port.large_window) \
        == (7, 18, True, True)


def test_headers_equal():
    from brotli_tpu.core.bitio import BitWriter as JW
    for mlen in (1, 2, 255, 65536, 65537, 1 << 20, 1 << 24):
        a, b = TBIO.BitWriter(), JW()
        for w, mod in ((a, TB), (b, JB)):
            mod.write_stream_header(w, 22)
            mod.store_uncompressed_meta_block(w, b"\x01" * min(mlen, 300))
            mod.write_mlen(w, mlen)
            mod.write_empty_last_meta_block(w)
            w.append_packed(np.array([0x0123456789ABCDEF, 0x55],
                                     np.uint64), 71)
        assert a.getvalue() == b.getvalue()


def test_native_invert_and_decode_equal():
    rng = np.random.default_rng(4)
    n = 5000
    pa, pb = rng.permutation(n), rng.permutation(n)
    va, vb = rng.integers(0, 1 << 30, n), rng.integers(0, 1 << 30, n)
    sa, sb = rng.integers(0, 300, n), rng.integers(0, 300, n)
    np.testing.assert_array_equal(tnb.invert_perm32(pa, va),
                                  jnb.invert_perm32(pa, va))
    want = np.empty(n, np.int64)
    want[pa] = va
    got = tnb.invert_merge32(pa, va, sa, pb, vb, sb)
    sc = np.empty(n, np.int64)
    sc[pa] = sa
    win = np.zeros(n, bool)
    win[pb] = sb > sc[pb]
    want[pb[win[pb]]] = vb[win[pb]]
    np.testing.assert_array_equal(got, want)
    from brotli_tpu import compress
    data = b"".join(tget_dict().data[i:i + 50] for i in range(0, 60000, 70))
    assert tnb.decode(compress(data, quality=9)) == data


def test_code_tables_equal():
    for name in ("INSERT_EXTRA", "INSERT_BASE", "COPY_EXTRA", "COPY_BASE",
                 "CMD_IMPLICIT_DIST0", "CODE_LENGTH_CODE_ORDER",
                 "CLCODE_BITS", "CLCODE_NBITS"):
        np.testing.assert_array_equal(getattr(TC, name), getattr(JC, name))
    assert TC.MAX_HUFF_BITS == JC.MAX_HUFF_BITS
    lens = np.concatenate([np.arange(0, 3000), [22594, 22595, 1 << 24]])
    np.testing.assert_array_equal(TC.get_insert_length_code(lens),
                                  JC.get_insert_length_code(lens))
    np.testing.assert_array_equal(TC.get_copy_length_code(lens + 2),
                                  JC.get_copy_length_code(lens + 2))


@pytest.mark.parametrize("seed", range(6))
def test_huffman_and_prefix_writer_equal(seed):
    """build_huffman_lengths, encoding_table and write_prefix_code on
    random histograms: sparse ones (simple codes), skewed ones (depth
    limit) and dense ones (complex codes with RLE)."""
    from brotli_tpu.core.bitio import BitWriter as JW
    from brotli_tpu.core.huffman import build_huffman_lengths
    from brotli_tpu.core.prefix import encoding_table, write_prefix_code
    rng = np.random.default_rng(seed)
    for size in (1, 4, 26, 256, 704):
        for shape in ("sparse", "skewed", "dense"):
            if shape == "sparse":
                hist = np.zeros(size, np.int64)
                hist[rng.integers(0, size, rng.integers(1, 5))] = \
                    rng.integers(1, 100)
            elif shape == "skewed":
                hist = (2 ** rng.integers(0, 30, size)) * \
                    (rng.random(size) < 0.7)
                hist[0] += 1
            else:
                hist = rng.integers(0, 50, size)
                hist[0] += 1
            a = THuf.build_huffman_lengths(hist)
            np.testing.assert_array_equal(a, build_huffman_lengths(hist))
            assert a.max() <= 15
            for x, y in zip(TPre.encoding_table(a), encoding_table(a)):
                np.testing.assert_array_equal(x, y)
            tw, jw = TBIO.BitWriter(), JW()
            tw.write(5, 3)
            jw.write(5, 3)
            TPre.write_prefix_code(tw, a)
            write_prefix_code(jw, a)
            assert tw.getvalue() == jw.getvalue()
            assert tw.bit_length() == jw.bit_length()


def test_bitwriter_checkpoint_equal():
    from brotli_tpu.core.bitio import BitWriter as JW
    tw, jw = TBIO.BitWriter(), JW()
    for w in (tw, jw):
        w.write(0x2D, 6)
        state = w.save_state()
        w.write(0xABCDE, 20)
        w.restore_state(state)
        w.write(3, 2)
    assert tw.getvalue() == jw.getvalue()
    assert tw.bit_length() == jw.bit_length() == 8


def test_native_resolve_and_pack_equal():
    from brotli_tpu.encode.command import command_extra_bits
    from brotli_tpu.encode.command import resolve_commands
    from brotli_tpu.encode.params import DistanceParams
    rng = np.random.default_rng(12)
    n = 3000
    ins = rng.integers(0, 40, n)
    cps = rng.integers(2, 300, n)
    cps[-1] = 0
    dst = np.where(rng.random(n) < 0.4, rng.choice([4, 11, 15, 16], n),
                   rng.integers(1, 60000, n))
    for cache in ((4, 11, 15, 16), (9, 300, 7, 12)):
        a, ca = TCmd.resolve_commands(ins, cps, dst, TDist(), advance=cps,
                                      initial_cache=cache, pos_offset=100,
                                      window_size=1 << 16)
        b, cb = resolve_commands(ins, cps, dst, DistanceParams(),
                                 advance=cps, initial_cache=cache,
                                 pos_offset=100, window_size=1 << 16)
        assert list(ca) == list(cb)
        for f in ("dist_code", "dist_extra", "dist_extra_bits", "cmd_sym",
                  "copy_advance"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for x, y in zip(TCmd.command_extra_bits(a), command_extra_bits(b)):
            np.testing.assert_array_equal(x, y)
    nbits = rng.integers(0, 33, 5000)
    bits = np.array([int(rng.integers(0, 1 << int(k))) if k else 0
                     for k in nbits], np.uint64)
    tw, tt = tnb.pack_bits(bits, nbits)
    jw, jt = jnb.pack_bits(bits, nbits)
    assert tt == jt
    np.testing.assert_array_equal(tw[:tt // 64 + 1], jw[:jt // 64 + 1])


def test_decode_constants_equal():
    for name in ("CMD_TO_INSERT_CODE", "CMD_TO_COPY_CODE",
                 "DISTANCE_SHORT_CODE_INDEX", "DISTANCE_SHORT_CODE_DELTA"):
        np.testing.assert_array_equal(getattr(TC, name), getattr(JC, name))
    for name in ("NUM_DISTANCE_SHORT_CODES", "REPEAT_PREVIOUS_CODE_LENGTH",
                 "REPEAT_ZERO_CODE_LENGTH"):
        assert getattr(TC, name) == getattr(JC, name), name
    for npostfix in range(4):
        for ndirect in range(0, 121, 8):
            for bits in (24, 30):
                assert TC.distance_alphabet_size(npostfix, ndirect, bits) \
                    == JC.distance_alphabet_size(npostfix, ndirect, bits)


@pytest.mark.parametrize("seed", range(4))
def test_prefix_reader_equal(seed):
    """read_prefix_code (and the PrefixDecoder it builds on) over the
    port's own write_prefix_code output: simple codes of 1-4 symbols and
    complex codes with RLE, read back by both packages."""
    from brotli_tpu.core.bitio import BitReader as JR
    from brotli_tpu.core.prefix import PrefixDecoder as JPD
    from brotli_tpu.core.prefix import check_complete
    from brotli_tpu.core.prefix import read_prefix_code
    rng = np.random.default_rng(100 + seed)
    for size in (4, 26, 256, 704):
        for shape in ("sparse", "dense"):
            hist = np.zeros(size, np.int64)
            if shape == "sparse":
                hist[rng.integers(0, size, rng.integers(1, 5))] = \
                    rng.integers(1, 100)
            else:
                hist = rng.integers(0, 50, size) * (rng.random(size) < 0.6)
                hist[0] += 1
            lengths = THuf.build_huffman_lengths(hist)
            w = TBIO.BitWriter()
            w.write(5, 3)
            TPre.write_prefix_code(w, lengths)
            stream = w.getvalue() + bytes(8)
            tr, jr = TBIO.BitReader(stream), JR(stream)
            tr.read(3)
            jr.read(3)
            got = TPre.read_prefix_code(tr, size)
            np.testing.assert_array_equal(got, read_prefix_code(jr, size))
            assert tr.bit_pos == jr.bit_pos
            assert TPre.check_complete(got) == check_complete(got)
            syms = np.nonzero(got)[0]
            np.testing.assert_array_equal(np.nonzero(lengths)[0], syms)
            td, jd = TPre.PrefixDecoder(got), JPD(got)
            assert td.single == jd.single and td.max_len == jd.max_len
            if td.single < 0:
                np.testing.assert_array_equal(td.sym_table, jd.sym_table)
                np.testing.assert_array_equal(td.len_table, jd.len_table)
    with pytest.raises(TBIO.NeedsMoreInput):
        TBIO.BitReader(b"\x01").read(9)
    with pytest.raises(ValueError):
        TPre.PrefixDecoder(np.array([1, 1, 1]))


def test_transforms_and_dict_len_tables_equal():
    from brotli_tpu.core.dictionary import apply_transform
    from brotli_tpu.ops.decode_tpu import _dict_len_tables as jlen
    from brotli_tpu_torch.core.dictionary import apply_transform as tapply
    from brotli_tpu_torch.ops.decode_gpu import _dict_len_tables as tlen
    td, jd = tget_dict(), jget_dict()
    words = [b"", b"a", b"hello", b"\xc3\xa9t\xc3\xa9", b"\xe2\x82\xacuro",
             b"zZ\xf0\x9f\x98\x80x"]
    # and seeded words of the dictionary itself, every length
    rng = np.random.default_rng(9)
    for length in range(4, 25):
        for _ in range(3):
            words.append(jd.word(length, int(rng.integers(
                0, td.num_words(length)))))
    for t in range(121):
        for wd in words:
            assert tapply(td, wd, t) == apply_transform(jd, wd, t), (t, wd)
    for a, b in zip(tlen(), jlen()):
        np.testing.assert_array_equal(a, b)


def test_native_lane_walk_and_lz_execute_equal():
    from brotli_tpu import compress
    data = b"".join(tget_dict().data[i:i + 40] for i in range(0, 30000, 90))
    # the JAX package's native walk takes a stream whose one compressed
    # metablock is final (q2, q3 here); the port's walk, which also
    # stops at a non-final one, reads the same fields there
    took = 0
    for q in (1, 2, 3, 9):
        s = compress(data, quality=q)
        a, b = tnb.lane_walk(s), jnb.parse_lane_header(s)
        if b is None:
            continue
        took += 1
        meta, pre, lit, cmd, dl = b
        segs, lane = a
        assert segs == pre
        assert lane[:7] == (meta[0], meta[1], meta[2], meta[3], meta[4],
                            meta[7], True)
        for x, y in zip(lane[7:], (lit, cmd, dl)):
            np.testing.assert_array_equal(x, y)
    assert took == 2
    # insert 100, copy 30 at distance 7, insert 150, a dictionary word
    # (word 5 of length 4 under transform 3), insert 150
    rng = np.random.default_rng(2)
    lits = rng.integers(0, 256, 400, dtype=np.uint8)
    prefix = b"prefix bytes " * 10
    word_id = (3 << int(tget_dict().size_bits_by_length[4])) + 5
    max_dist = len(prefix) + 280
    cmds = np.array([[100, 30, 7], [150, 4, max_dist + 1 + word_id],
                     [150, 0, 0]], np.int32)
    mlen = 430 + len(jget_dict().resolve(4, word_id))
    for m in (mlen, mlen - 1):
        got = tnb.lz_execute(prefix, lits, cmds, 3, 1 << 16, m)
        assert got == jnb.lz_execute(prefix, lits, cmds, 3, 1 << 16, m)
        assert (got is None) == (m != mlen)
