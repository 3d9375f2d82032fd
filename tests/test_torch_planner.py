"""The port's pure-Python metablock planner and store against
brotli_tpu's, on the CPU.

The planner (encode/metablock.py: split_symbols,
cluster_context_histograms, plan_block_switches, build_meta_block) and
the store (encode/bitstream.py: write_count_code, mtf_encode,
write_context_map, store_meta_block with the multi-tree
emit_command_stream) must equal the JAX package's (tolerance: none):
every plan field, every byte.  The commands are the port's own encoder's
(its resolve_commands logged during compress), resolved again from the
initial distance cache behind an uncompressed prefix, so that each block
stands as the last metablock of a stream that libbrotlidec decodes.
On the blocks the native store refuses for its buffer, the pure-Python
route's bytes equal the native store's on a buffer for the worst case
(native_bridge.worst_case_bits).
"""

import dataclasses
import functools

import numpy as np
import pytest

from brotli_tpu.core.bitio import BitWriter as JW
from brotli_tpu.encode import bitstream as JS
from brotli_tpu.encode import command as JC
from brotli_tpu.encode import metablock as JM
from brotli_tpu.encode.params import DistanceParams as JDP
from brotli_tpu_torch import compress
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.core.bitio import BitReader, BitWriter as TW
from brotli_tpu_torch.decode.decoder import _read_context_map
from brotli_tpu_torch.encode import bitstream as TS
from brotli_tpu_torch.encode import encoder as E
from brotli_tpu_torch.encode import metablock as TM
from brotli_tpu_torch.encode.command import resolve_commands
from brotli_tpu_torch.encode.params import DistanceParams as TDP
from . import oracle
from .test_torch_encoder import (count_planner_calls, dictionary_slice,
                                 low_entropy, phrases)
from .test_torch_utils import random_bytes, records, repo_text, same
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LGWIN = 22
INPUTS = {
    # mostly UTF-8: the UTF8 context mode and its static maps
    "text": repo_text(20_000) + phrases(10_000, seed=51) + records(4_000)
    + dictionary_slice(20_000, 23_000),
    # mostly binary: the SIGNED context mode
    "binary": records(20_000) + random_bytes(6_000) + repo_text(8_000),
    # two metablocks at lgblock 16
    "long": repo_text(50_000) + phrases(30_000, seed=52),
}


@functools.lru_cache(maxsize=None)
def segments(name: str, quality: int, lgblock: int = 0) -> list:
    """(insert, copy, distance, advance, start) of each metablock the
    port's encoder resolves for INPUTS[name] (or low_entropy)."""
    data = INPUTS[name] if name in INPUTS else low_entropy(300_000)
    logged = []
    real = E.resolve_commands

    def log(ins, cps, dst, dist_params, advance=None, pos_offset=0,
            **kw):
        if not logged or logged[-1][4] != pos_offset:
            logged.append((ins, cps, dst, advance, pos_offset))
        return real(ins, cps, dst, dist_params, advance=advance,
                    pos_offset=pos_offset, **kw)

    E.resolve_commands = log
    try:
        compress(data, quality=quality, lgwin=LGWIN, lgblock=lgblock,
                 metablock_callback=lambda *a: None)
    finally:
        E.resolve_commands = real
    return data, logged


def block(name, quality, dp=None, index=0, lgblock=0):
    """One metablock's data, start, mlen and commands in both packages'
    types, resolved from the initial distance cache."""
    data, segs = segments(name, quality, lgblock)
    ins, cps, dst, adv, start = segs[index]
    mlen = int(np.sum(ins) + np.sum(adv))
    tdp = dp or TDP()
    cmds, _ = resolve_commands(ins, cps, dst, tdp, advance=adv,
                               pos_offset=start,
                               window_size=(1 << LGWIN) - 16)
    jcmds = JC.CommandArrays(**{f.name: getattr(cmds, f.name)
                                for f in dataclasses.fields(cmds)})
    jdp = JDP(npostfix=tdp.npostfix, ndirect=tdp.ndirect,
              large_window=tdp.large_window)
    full = np.frombuffer(data, np.uint8)
    return full, start, mlen, cmds, jcmds, tdp, jdp


def stream_of(writer_cls, store, full, start, lgwin=LGWIN) -> bytes:
    """A stream: the window header, the bytes before `start` stored
    uncompressed, then `store(writer)` as the last metablock."""
    w = writer_cls()
    mod = TS if writer_cls is TW else JS
    mod.write_stream_header(w, lgwin)
    if start:
        mod.store_uncompressed_meta_block(w, full[:start].tobytes())
    store(w)
    return w.getvalue()


def same_plan(a, b) -> None:
    for slot in JM.MetaBlockPlan.__slots__:
        x, y = getattr(a, slot), getattr(b, slot)
        if slot in ("cmds", "dist_params"):
            same(dataclasses.asdict(x), dataclasses.asdict(y))
        else:
            same(x, y)


# ---------------------------------------------------------------------------
# build_meta_block + store_meta_block
# ---------------------------------------------------------------------------

VARIANTS = {
    "default": dict(),
    "no_splits": dict(enable_splits=False),
    "one_literal_context": dict(num_lit_ctx=1,
                                lit_static_map=np.zeros(64, np.int64)),
    "npostfix2_ndirect8": dict(dp=(2, 8)),
    "npostfix1_ndirect30": dict(dp=(1, 30), enable_splits=False),
    "size_hint_1mib": dict(size_hint=1 << 20),
    "mode_font": dict(mode=2),
}


CASES = [(q, v) for q in (4, 5, 9, 10, 11)
         for v in ("default", "no_splits")] + [
    (5, "one_literal_context"), (10, "one_literal_context"),
    (5, "npostfix2_ndirect8"), (11, "npostfix2_ndirect8"),
    (9, "npostfix1_ndirect30"), (9, "size_hint_1mib"),
    (11, "size_hint_1mib"), (5, "mode_font")]


@pytest.mark.parametrize("quality, variant", CASES)
def test_plan_and_store_match_jax(quality, variant):
    kw = dict(VARIANTS[variant])
    dp = kw.pop("dp", None)
    size_hint = kw.pop("size_hint", 0)
    name = "binary" if variant == "mode_font" else "text"
    full, start, mlen, cmds, jcmds, tdp, jdp = block(
        name, quality, TDP(npostfix=dp[0], ndirect=dp[1]) if dp else None)
    want = JM.build_meta_block(full, start, mlen, jcmds, jdp, quality,
                               size_hint, **kw)
    got = TM.build_meta_block(full, start, mlen, cmds, tdp, quality,
                              size_hint, **kw)
    same_plan(want, got)
    a = stream_of(JW, lambda w: JS.store_meta_block(w, want, True), full,
                  start)
    b = stream_of(TW, lambda w: TS.store_meta_block(w, got, True), full,
                  start)
    assert a == b
    assert oracle.decompress(b, start + mlen + 1) == full[:start +
                                                         mlen].tobytes()
    if variant == "default":
        # the block is planned with block types and context trees
        assert got.lit_ntypes * got.cmd_ntypes > 1
        assert got.ntrees_l >= 2
        assert (got.dist_params.npostfix, got.dist_params.ndirect) == (0, 0)
    if variant.startswith("npostfix"):
        assert got.dist_params.npostfix == dp[0]


@pytest.mark.parametrize("quality", [5, 11])
def test_plan_and_store_binary_and_later_blocks(quality):
    """SIGNED context mode, and a metablock that does not start the
    input (positions and dictionary distances counted from its start)."""
    for name, index in (("binary", 0), ("long", 1)):
        full, start, mlen, cmds, jcmds, tdp, jdp = block(
            name, quality, index=index, lgblock=16)
        want = JM.build_meta_block(full, start, mlen, jcmds, jdp, quality,
                                   0)
        got = TM.build_meta_block(full, start, mlen, cmds, tdp, quality, 0)
        same_plan(want, got)
        b = stream_of(TW, lambda w: TS.store_meta_block(w, got, True), full,
                      start)
        assert b == stream_of(JW, lambda w: JS.store_meta_block(
            w, want, True), full, start)
        assert oracle.decompress(b, start + mlen + 1) == \
            full[:start + mlen].tobytes()
        assert start == (0 if index == 0 else 1 << 16)


# ---------------------------------------------------------------------------
# the planner's parts
# ---------------------------------------------------------------------------

def _symbol_streams():
    full, start, mlen, cmds, _, tdp, _ = block("text", 9)
    lits = TS.extract_literals(full, start, cmds.insert_len,
                               cmds.copy_advance).astype(np.int64)
    mask = (cmds.copy_len > 0) & ~TM.C.CMD_IMPLICIT_DIST0[cmds.cmd_sym]
    return {
        "literal": (lits, 256),
        "command": (cmds.cmd_sym, 704),
        "distance": (cmds.dist_code[mask], tdp.alphabet_size),
    }


@pytest.mark.parametrize("max_types", [None, 2, 256])
@pytest.mark.parametrize("category", ["literal", "command", "distance"])
def test_split_symbols_and_switch_plans_match_jax(category, max_types):
    syms, alpha = _symbol_streams()[category]
    for part in (syms, syms[:127], syms[:400], np.zeros(0, np.int64)):
        want = JM.split_symbols(part, alpha, category, max_types=max_types)
        got = TM.split_symbols(part, alpha, category, max_types=max_types)
        assert got.num_types == want.num_types
        same(want.types, got.types)
        same(want.blocks, got.blocks)
        if got.num_types >= 2:
            same(JM.plan_block_switches(want), TM.plan_block_switches(got))
    if category == "literal":
        assert TM.split_symbols(syms, alpha, category).num_types >= 2


def test_plan_block_switches_matches_jax():
    """Long and short blocks (every length code), the three type-symbol
    forms (previous, next, explicit)."""
    rng = np.random.default_rng(61)
    for ntypes in (2, 3, 7):
        lens = rng.integers(1, 1 << 17, 40) // rng.integers(1, 4000, 40) + 1
        types = [0]
        for _ in range(len(lens) - 1):
            t = int(rng.integers(0, ntypes))
            types.append(t if t != types[-1] else (t + 1) % ntypes)
        blocks = list(zip(types, map(int, lens)))
        arr = np.repeat(np.array(types, np.int64), lens)
        a = JM.BlockSplit(ntypes, arr, blocks)
        b = TM.BlockSplit(ntypes, arr, blocks)
        same(JM.plan_block_switches(a), TM.plan_block_switches(b))


@pytest.mark.parametrize("alpha", [256, 704, 64])
def test_cluster_context_histograms_matches_jax(alpha):
    rng = np.random.default_rng(alpha)
    for nb_, used, max_trees, cost in ((64, 20, 48, 300.0),
                                       (256, 200, 48, 300.0),
                                       (16, 3, 8, 500.0), (8, 0, 8, 500.0)):
        hist = np.zeros((nb_, alpha), np.int64)
        rows = rng.choice(nb_, used, replace=False)
        for r in rows:
            k = int(rng.integers(1, alpha))
            hist[r, rng.integers(0, k, 200)] += rng.integers(1, 9, 200)
        want = JM.cluster_context_histograms(hist, max_trees, cost)
        got = TM.cluster_context_histograms(hist, max_trees, cost)
        same(want, got)


def test_entropy_cost_and_literal_positions_match_jax():
    full, start, mlen, cmds, jcmds, _, _ = block("text", 5)
    same(JM._literal_positions(jcmds, start),
         TM._literal_positions(cmds, start))
    for h in (np.zeros(4, np.int64), np.arange(300), np.ones(704)):
        same(JM._entropy_cost(h), TM._entropy_cost(h))
        same(JM._safe(h), TM._safe(h))


# ---------------------------------------------------------------------------
# the store's parts
# ---------------------------------------------------------------------------

def test_write_count_code_matches_jax():
    for v in range(1, 257):
        a, b = JW(), TW()
        JS.write_count_code(a, v)
        TS.write_count_code(b, v)
        assert b.getvalue() == a.getvalue()
        assert b.bit_length() == a.bit_length()


def _context_maps():
    rng = np.random.default_rng(71)
    out = [np.zeros(64, np.int64), np.arange(64, dtype=np.int64) % 2,
           np.repeat(np.arange(4, dtype=np.int64), 16),
           np.tile(TM.STATIC_CONTEXT_MAP_COMPLEX_UTF8, 3) + 1]
    for ntrees in (2, 13, 48, 256):
        for zeros in (0.0, 0.6, 0.97):
            m = rng.integers(0, ntrees, 64 * 5)
            m[rng.random(len(m)) < zeros] = 0
            out.append(m.astype(np.int64))
    return out


@pytest.mark.parametrize("k", range(16))
def test_mtf_and_context_maps_match_jax(k):
    cmap = _context_maps()[k]
    ntrees = int(cmap.max()) + 1
    same(JS.mtf_encode(cmap), TS.mtf_encode(cmap))
    if ntrees < 2:
        return
    a, b = JW(), TW()
    JS.write_context_map(a, cmap, ntrees)
    TS.write_context_map(b, cmap, ntrees)
    b.write(0, 7)  # room for the reader's last peek
    assert b.getvalue()[:len(a.getvalue())] == a.getvalue()
    reader = BitReader(b.getvalue())
    same(cmap, _read_context_map(reader, len(cmap), ntrees))


# ---------------------------------------------------------------------------
# the route of the blocks the native store refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [4, 5, 9])
def test_refused_blocks_python_route_equals_native_worst_case(
        quality, monkeypatch):
    """Full metablocks of one long insert: the native store refuses
    them on its buffer; store_meta_block_auto then runs the pure-Python
    planner, whose bytes equal the native store's on a worst-case
    buffer, and the JAX package's."""
    segments("low_entropy", quality, 16)
    planned = count_planner_calls(monkeypatch)
    real = nb.store_metablock
    n_refused = 0
    for index in range(4):
        full, start, mlen, cmds, jcmds, tdp, jdp = block(
            "low_entropy", quality, index=index, lgblock=16)
        args = (full, start, mlen, cmds, tdp, quality, 0, 0, True)

        def route(w, store=real):
            monkeypatch.setattr(nb, "store_metablock", store)
            TS.store_meta_block_auto(w, *args)

        python = stream_of(TW, route, full, start)
        worst = stream_of(TW, functools.partial(route, store=functools.partial(
            real, cap_bits=nb.worst_case_bits(mlen))), full, start)
        jax = stream_of(JW, lambda w: JS.store_meta_block_auto(
            w, full, start, mlen, jcmds, jdp, quality, 0, 0, True), full,
            start)
        refused = real(full, start, mlen, True, cmds, tdp.npostfix,
                       tdp.ndirect, tdp.alphabet_size, quality, 3, 1,
                       np.zeros(64, np.int64), TM.C.CONTEXT_LUT0[3],
                       TM.C.CONTEXT_LUT1[3]) is None
        n_refused += refused
        assert python == worst == jax
        assert len(python) < start + mlen
        assert oracle.decompress(python, start + mlen + 1) == \
            full[:start + mlen].tobytes()
    assert n_refused == 4
    assert len(planned) == 4
