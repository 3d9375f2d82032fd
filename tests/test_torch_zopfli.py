"""The port's optimal parser (quality 9.5 to 11, encode/zopfli.py) against
brotli_tpu's, on the CPU.

Every stream equals the JAX package's byte for byte (tolerance: none)
and decodes through the system libbrotlidec (tests/oracle.py; a custom
dictionary spliced in front, a bare part behind its prefix, as
tests/test_torch_encoder.py does).  The tiers: q10, q11, quality 12,
q9_5 at quality 9 (plain q9), 10 and 12, q10_deep; the stream flags at
q11; a multi-metablock input (the one-ahead collection); a 256 KiB
single metablock (the overlapped tier, which must produce the stream
itself); compress_multi, compress_batch and compress_mesh at q10/q11;
and the modules one by one: zopfli_collect, the edge-list DP,
choose_distance_params, collect_dict_matches, the literal costs and
extend_match.  Inputs are 16-64 KiB of seeded phrases, random bytes and
dictionary slices.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

import brotli_tpu
from brotli_tpu.encode import metablock as JM
from brotli_tpu.encode import static_dict as JS
from brotli_tpu.encode import zopfli as JZ
from brotli_tpu.encode.command import resolve_commands as j_resolve
from brotli_tpu.encode.match import extend_match as j_extend_match
from brotli_tpu.encode.params import EncoderParams as JParams
from brotli_tpu_torch import (compress, compress_batch, compress_mesh,
                              compress_multi, make_mesh)
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.encode import encoder as E
from brotli_tpu_torch.encode import metablock as M
from brotli_tpu_torch.encode import static_dict as S
from brotli_tpu_torch.encode import zopfli as Z
from brotli_tpu_torch.encode.command import resolve_commands
from brotli_tpu_torch.encode.match import extend_match
from brotli_tpu_torch.encode.params import EncoderParams
from .test_torch_encoder import (CUSTOM_DICTIONARY, PREFIX, after_prefix,
                                 decodes, dictionary_slice, phrases)
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TEXT = phrases(40_000, seed=31) + dictionary_slice(50_000, 60_000)
MIXED = (phrases(20_000, seed=32)
         + np.random.default_rng(33).integers(0, 256, 6_000,
                                              dtype=np.uint8).tobytes()
         + bytes(range(256)) * 24 + phrases(10_000, seed=34))


def records(n: int = 600, seed: int = 40) -> bytes:
    """n 64-byte records of one seeded base, 6% of their bytes seeded
    noise: copies at multiples of 64 bytes, for which the distance
    search leaves NPOSTFIX/NDIRECT (0, 0)."""
    rng = np.random.default_rng(seed)
    recs = np.tile(rng.integers(0, 256, 64, dtype=np.uint8), (n, 1))
    noise = rng.random(recs.shape) < 0.06
    recs[noise] = rng.integers(0, 256, int(noise.sum()), dtype=np.uint8)
    return recs.tobytes()


RECORDS = records()
INPUTS = {"text": TEXT, "mixed": MIXED, "records": RECORDS}

TIERS = {
    "q10": dict(quality=10),
    "q11": dict(quality=11),
    "q12": dict(quality=12),
    "q9_q9_5": dict(quality=9, q9_5=True),
    "q10_q9_5": dict(quality=10, q9_5=True),
    "q12_q9_5": dict(quality=12, q9_5=True),
    "q10_deep": dict(quality=10, q10_deep=True),
}

FLAGS = {
    "lgwin10": dict(lgwin=10),
    "lgwin24": dict(lgwin=24),
    "large_window": dict(large_window=True, lgwin=26),
    "custom_dictionary": dict(custom_dictionary=CUSTOM_DICTIONARY),
    "catable_appendable": dict(catable=True, appendable=True),
    "bare": dict(bare=True, catable=True),
    "magic_number": dict(magic_number=True),
    "avoid_distance_prefix_search": dict(avoid_distance_prefix_search=True),
}


def _check(data: bytes, **kw) -> bytes:
    got = compress(data, **kw)
    assert got == brotli_tpu.compress(data, **kw)
    if kw.get("bare"):
        head = compress(PREFIX, quality=5, appendable=True, byte_align=True)
        decodes(after_prefix(got, head), PREFIX + data)
    else:
        decodes(got, data, large_window=kw.get("large_window", False),
                dictionary=kw.get("custom_dictionary", b""))
    return got


@pytest.mark.parametrize("name", INPUTS)
@pytest.mark.parametrize("tier", TIERS)
def test_tiers_match_jax(tier, name):
    got = _check(INPUTS[name], **TIERS[tier])
    if tier == "q9_q9_5":
        assert got == compress(INPUTS[name], quality=9)


@pytest.mark.parametrize("flags", FLAGS)
def test_stream_flags_at_q11_match_jax(flags):
    _check(TEXT, quality=11, **FLAGS[flags])


def test_distance_prefix_search_changes_the_stream():
    """On RECORDS the search leaves (0, 0) at q11, and the stream
    differs from the one without the search."""
    picked = []
    real = M.choose_distance_params

    def spy(*a, **k):
        picked.append(real(*a, **k))
        return picked[-1]

    with mock.patch.object(E, "choose_distance_params", spy):
        a = _check(RECORDS, quality=11)
    assert any((p.npostfix, p.ndirect) != (0, 0) for p in picked)
    assert a != compress(RECORDS, quality=11,
                         avoid_distance_prefix_search=True)


def _ir(commands) -> list:
    return [(type(c).__name__, dataclasses.asdict(c)) for c in commands]


@pytest.mark.parametrize("quality", [10, 11])
def test_metablock_callback_matches_jax(quality):
    """The IR handed to the callback, over three metablocks of 64 KiB,
    and the stream equal the JAX package's."""
    data = TEXT + phrases(100_000, seed=39)
    seen = {"port": [], "jax": []}
    outs = {}
    for key, fn in (("port", compress), ("jax", brotli_tpu.compress)):
        outs[key] = fn(data, quality=quality, lgblock=16,
                       metablock_callback=lambda ir, block, key=key:
                       seen[key].append((ir, block)))
    assert outs["port"] == outs["jax"]
    assert len(seen["port"]) == len(seen["jax"]) == 3
    for (ir_a, block_a), (ir_b, block_b) in zip(seen["port"], seen["jax"]):
        assert block_a == block_b
        assert _ir(ir_a) == _ir(ir_b)
    kinds = {type(c).__name__ for ir, _ in seen["port"] for c in ir}
    assert {"Literal", "Copy", "Dict"} <= kinds
    decodes(outs["port"], data)


@pytest.mark.parametrize("kw", [dict(quality=10), dict(quality=11),
                                dict(quality=10, q10_deep=True)])
def test_multi_metablock_prefetch_matches_jax(kw, monkeypatch):
    """lgblock 16 over 150 KiB: three metablocks, each region's
    candidates collected one metablock ahead, every one with the window
    before it as its dictionary."""
    data = phrases(100_000, seed=35) + dictionary_slice(0, 50_000)
    calls = []
    real = Z.zopfli_collect

    def spy(full, params, dict_len=0, iters=None):
        calls.append((len(full), dict_len))
        return real(full, params, dict_len, iters)

    monkeypatch.setattr(E, "zopfli_collect", spy)
    _check(data, lgblock=16, **kw)
    assert len(calls) == 3
    assert [k for _, k in calls] == [0, 1 << 16, 2 << 16]


def test_single_metablock_q10_runs_the_overlapped_tier(monkeypatch):
    """A single metablock of 256 KiB at one iteration: the overlapped
    tier must produce the stream (no fallback), equal to the JAX
    package's."""
    data = (phrases(200_000, seed=36) + dictionary_slice(0, 40_000)
            + np.random.default_rng(37).integers(0, 256, 22_144,
                                                 dtype=np.uint8).tobytes())
    assert len(data) == 1 << 18
    produced = []
    real = Z._zopfli_segment_fast_overlapped

    def spy(*a):
        produced.append(real(*a))
        return produced[-1]

    monkeypatch.setattr(Z, "_zopfli_segment_fast_overlapped", spy)
    _check(data, quality=10)
    assert len(produced) == 1 and produced[0] is not None


def test_overlapped_tier_matches_jax():
    """The overlapped tier alone, on both packages: the JAX package's
    returns too (no exception, no decline), with the same commands."""
    data = np.frombuffer(phrases(1 << 18, seed=38), np.uint8)
    p, jp = _params(10)
    got = Z._zopfli_segment_fast_overlapped(data, p, (4, 11, 15, 16))
    want = JZ._zopfli_segment_fast_overlapped(data, jp, (4, 11, 15, 16))
    assert want is not None
    _same(got, want)
    assert sum(got[0]) + sum(got[3]) == len(data)


@pytest.mark.parametrize("quality", [10, 11])
@pytest.mark.parametrize("backend", ["thread", "serial", "process",
                                     "workpool"])
def test_compress_multi_matches_jax(backend, quality):
    data = TEXT[:48_000]
    got = compress_multi(data, 3, quality=quality, backend=backend)
    assert got == brotli_tpu.compress_multi(data, 3, quality=quality,
                                            backend=backend)
    decodes(got, data)
    if backend == "serial":
        assert got == compress_multi(data, 3, quality=quality,
                                     backend="thread")


def test_compress_batch_at_q11_matches_jax():
    payloads = [TEXT[:30_000], MIXED[:20_000], b"", b"abc" * 3000]
    got = compress_batch(payloads, threads=3, quality=11)
    assert got == brotli_tpu.compress_batch(payloads, threads=3,
                                            quality=11)
    for out, data in zip(got, payloads):
        decodes(out, data)


def test_compress_mesh_small_input_at_q11_equals_compress():
    data = TEXT[:8 * 4096 - 1]
    got = compress_mesh(data, mesh=make_mesh(8, device="cpu"), quality=11)
    assert got == compress(data, quality=11)
    assert got == brotli_tpu.compress(data, quality=11)
    decodes(got, data)


def _params(quality, **kw):
    return (EncoderParams(quality=quality, **kw).sanitize(None),
            JParams(quality=quality, **kw).sanitize(None))


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("dict_len", [0, 12_000])
def test_zopfli_collect_matches_jax(iters, dict_len):
    full = np.frombuffer(MIXED, np.uint8)
    p, jp = _params(11 if iters == 3 else 10)
    got = Z.zopfli_collect(full, p, dict_len, iters=iters)
    want = JZ.zopfli_collect(full, jp, dict_len, iters=iters)
    _same(got, want)
    # the single-iteration tier's rows, else the deep rings; the
    # dictionary matches in both
    rows = 3 if iters == 1 else 0
    assert got["cand_lens"].shape == (rows, len(full) - dict_len)
    assert len(got["extra"]) == (1 if iters == 1 else 2)


def test_edge_list_dp_matches_jax():
    """_prepare_edges, _price_edges and zopfli_parse (the DP over an edge
    list, on the runtime's zopfli_dp_cache) against the JAX package's;
    and the cache-free zopfli_dp binding."""
    full = np.frombuffer(TEXT[:20_000], np.uint8)
    p, jp = _params(11)
    col = Z.zopfli_collect(full, p, 0, iters=1)
    n = len(full)
    args = (col["cand_lens"], col["cand_dists"], col["cand_isdict"],
            col["cand_wire"])
    prep = Z._prepare_edges(*args, p.dist, n, extra=col["extra"])
    jprep = JZ._prepare_edges(*args, jp.dist, n, extra=col["extra"])
    _same(prep, jprep)
    cost_dist = np.log2(20.0 + np.arange(p.dist.alphabet_size))
    cost_cmd = np.log2(11.0 + np.arange(704))
    edges = Z._price_edges(prep, cost_dist)
    _same(edges, JZ._price_edges(jprep, cost_dist))
    lcp = np.concatenate([[0.0], np.cumsum(col["lit_costs"])])
    tail = (cost_dist[:16].copy(), full, 0, p.window_size,
            np.array([4, 11, 15, 16]))
    got = Z.zopfli_parse(n, lcp, cost_cmd, edges + tail)
    _same(got, JZ.zopfli_parse(n, lcp, cost_cmd, edges + tail))
    assert sum(got[0]) + sum(got[3]) == n
    from brotli_tpu import native_bridge as jnb
    dp_args = (n, lcp, cost_cmd, *edges[:6], Z._INS_CODE, Z.C.INSERT_EXTRA,
               Z._CMD_SYM.reshape(-1))
    _same(nb.zopfli_dp(*dp_args), jnb.zopfli_dp(*dp_args))


@pytest.mark.parametrize("size", [3_000, 40_000])
@pytest.mark.parametrize("quality", [10, 11])
def test_choose_distance_params_matches_jax(quality, size):
    """On the commands of a parse; 40,000 copies of seeded far distances
    take the lane pool (2^15 distances and more)."""
    full = np.frombuffer(MIXED, np.uint8)
    p, _ = _params(quality)
    ins, cps, dst, adv = Z.zopfli_segment(full, p)
    cmds, _ = resolve_commands(ins, cps, dst, p.dist, advance=adv)
    rng = np.random.default_rng(size)
    dists = np.concatenate([cmds.distance,
                            rng.integers(1, 1 << 20, size)])
    codes = np.concatenate([cmds.dist_code, np.full(size, 40)])
    mask = np.concatenate([cmds.copy_len > 0, np.ones(size, bool)])
    for lw in (False, True):
        got = M.choose_distance_params(dists, mask, codes, large_window=lw)
        want = JM.choose_distance_params(dists, mask, codes,
                                         large_window=lw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got = M.choose_distance_params(dists[:0], mask[:0], codes[:0])
    assert (got.npostfix, got.ndirect) == (0, 0)


@pytest.mark.parametrize("window", [(1 << 10) - 16, (1 << 22) - 16])
@pytest.mark.parametrize("dict_len", [0, 5_000])
def test_collect_dict_matches_matches_jax(dict_len, window):
    full = np.frombuffer(TEXT, np.uint8)
    got = S.collect_dict_matches(full, dict_len, window)
    want = JS.collect_dict_matches(full, dict_len, window)
    _same(got, want)
    assert len(got[0]) > 1000
    assert np.all(np.diff(got[0]) >= 0)
    # caller-owned rows and progress marks, as the overlapped tier uses
    rows = [np.zeros(6 * len(full) + 64, np.int64) for _ in range(4)]
    progress = np.zeros(2, np.int64)
    _same(S.collect_dict_matches(full, dict_len, window, progress=progress,
                                 out=rows), want)
    assert progress.tolist() == [len(full) - dict_len, len(want[0])]
    short = [np.zeros(8, np.int64) for _ in range(4)]
    assert S.collect_dict_matches(full, dict_len, window, out=short) is None


def test_sorted_dict_index_matches_jax():
    got, want = S.sorted_dict_index(), JS.sorted_dict_index()
    _same(got, want)
    assert not got[0].flags.writeable


@pytest.mark.parametrize("name", ["text", "mixed", "utf8", "binary"])
def test_literal_costs_match_jax(name):
    data = {"text": TEXT, "mixed": MIXED,
            "utf8": "ünïcödé ✓ " .encode() * 3_000,
            "binary": bytes(range(256)) * 40}[name]
    arr = np.frombuffer(data, np.uint8)
    _same(Z.estimate_literal_costs(arr), JZ.estimate_literal_costs(arr))
    assert len(Z.estimate_literal_costs(arr[:0])) == 0


def test_extend_match_matches_jax_and_the_runtime():
    data = np.frombuffer(b"xyz" + b"abcd" * 5_000 + b"q", np.uint8)
    for cand, pos, cur, limit in ((3, 7, 320, len(data) - 7),
                                  (3, 11, 4, 100), (0, 1, 0, 50)):
        got = extend_match(data, cand, pos, cur, limit)
        assert got == j_extend_match(data, cand, pos, cur, limit)
    ext = nb.extend_caps(data, 0, np.array([7]), np.array([4]),
                         np.array([320]))
    assert ext[0] == extend_match(data, 3, 7, 320, len(data) - 7)
    state = np.full(1, -1, np.int64)
    assert nb.extend_caps_range(data, 0, np.array([7]), np.array([4]),
                                np.array([320]), state)[0] == ext[0]
    assert state[0] >= 7 + ext[0] - 1


def test_resolve_after_the_parse_matches_jax():
    """The parse's commands resolve alike in both packages (the store's
    input)."""
    full = np.frombuffer(TEXT, np.uint8)
    p, jp = _params(11)
    ins, cps, dst, adv = Z.zopfli_segment(full, p)
    a, ca = resolve_commands(ins, cps, dst, p.dist, advance=adv)
    b, cb = j_resolve(ins, cps, dst, jp.dist, advance=adv)
    assert ca == cb
    for f in ("insert_len", "copy_len", "distance", "dist_code",
              "dist_extra", "cmd_sym"):
        assert np.array_equal(getattr(a, f), getattr(b, f))


def test_overlapped_tier_declines_when_dictionary_rows_overflow(
        monkeypatch):
    """Where the dictionary matches overflow the tier's rows, the tier
    returns None (the caller parses serially) instead of waiting for a
    progress mark that never comes (the JAX package's wait)."""
    data = np.frombuffer(phrases(1 << 18, seed=42), np.uint8)
    p, _ = _params(10)
    monkeypatch.setattr(S, "collect_dict_matches", lambda *a, **k: None)
    assert Z._zopfli_segment_fast_overlapped(data, p,
                                             (4, 11, 15, 16)) is None


def test_caller_owned_rows_are_checked():
    """The bridge refuses rows the native code would overrun or misread
    (a wrong dtype, too short, not contiguous)."""
    data = np.frombuffer(TEXT[:5_000], np.uint8)
    n = len(data)
    good = [np.zeros(n, np.int64) for _ in range(5)]
    isd = np.zeros(n, np.uint8)
    for bad in (np.zeros(n, np.int32), np.zeros(n - 1, np.int64),
                np.zeros(2 * n, np.int64)[::2]):
        with pytest.raises(ValueError, match="caller-owned"):
            nb.find_best_matches(data, (1 << 22) - 16, out=(
                bad, good[1], good[2], isd, good[3], None, None))
    with pytest.raises(ValueError, match="top-2"):
        nb.find_best_matches(data, (1 << 22) - 16, want_top2=True, out=(
            *good[:3], isd, good[3], None, None))
    with pytest.raises(ValueError, match="caller-owned"):
        nb.zopfli_dp_cands(n, np.zeros(n + 1), np.zeros(704), np.zeros(16),
                           np.zeros((4, 64)), (np.zeros(n + 1, np.int64),
                                               np.empty(0, nb.ZCAND_DTYPE)),
                           Z._INS_CODE, Z.C.INSERT_EXTRA, Z._CMD_SYM,
                           Z._CMD_SYM_LAST, data, 0, 1 << 20, [4, 11, 15, 16],
                           state_bufs=(np.empty(n + 1, np.float64),
                                       *[np.empty(n + 1, np.int32)
                                         for _ in range(4)],
                                       np.empty(4 * (n + 1), np.int32)))
