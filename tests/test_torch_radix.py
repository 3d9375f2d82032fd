"""The radix probes' primitives (brotli_tpu_torch/ops/radix_cuda.py) and
the probes' entry points (brotli_tpu_torch/research/radix_probe*.py)
against the TPU kernel bodies of research/radix_probe.py and
research/radix_probe2.py.

The bodies are closures inside the research scripts' main() and cannot
be imported: this file holds a verbatim copy of each, run through
pl.pallas_call(interpret=True) with the scripts' block specs, and
test_bodies_are_verbatim checks each copy against the scripts' text.
The one difference is hist_kernel's accumulate line: the script's
`[0].reshape(1, 128)` adds a (1, 128) value into a (128,) slice and
raises while tracing (jax 0.9.0), so the copy drops the `.reshape`.
Tolerance: exact (assert_array_equal) throughout.
"""

import hashlib
import inspect
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from brotli_tpu_torch.ops import fold_cuda as F
from brotli_tpu_torch.ops import radix_cuda as RC
from brotli_tpu_torch.research import gather_ab as GA
from brotli_tpu_torch.research import hist8_ab as H8
from brotli_tpu_torch.research import radix_probe as RP
from brotli_tpu_torch.research import radix_probe2 as RP2
from brotli_tpu_torch.research.corpus import SEED, make_corpus
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, C = 64, 16   # copy_kernel's closure: runs, rows per run


# ---------------------------------------------------------------------------
# Verbatim copies of the TPU bodies
# ---------------------------------------------------------------------------


def gather_kernel(x_ref, idx_ref, out_ref):
    out_ref[...] = jnp.take_along_axis(x_ref[...], idx_ref[...],
                                       axis=0)


def gather1_kernel(x_ref, idx_ref, out_ref):
    out_ref[...] = jnp.take_along_axis(x_ref[...], idx_ref[...],
                                       axis=1)


def hist_kernel(x_ref, out_ref):
    x = x_ref[...] & 0xFF
    acc = jnp.zeros((8, 128), jnp.int32)
    # 256 equality sweeps accumulated into (8,128) partials:
    # digit d counted at (d // 32, d % 32 * 4 ... ) — layout is
    # irrelevant for the cost probe, only the sweep count is
    for d in range(256):
        m = (x == d).astype(jnp.int32)
        acc = acc.at[d % 8].add(jnp.sum(m, axis=0, keepdims=True)
                                [0])
    out_ref[...] = acc


def copy_kernel(off_ref, src_ref, dst_ref, sem):
    def body(i, _):
        o = off_ref[i]
        cp = pltpu.make_async_copy(
            src_ref.at[pl.ds(o, C)], dst_ref.at[pl.ds(o, C)], sem)
        cp.start()
        cp.wait()
        return 0

    jax.lax.fori_loop(0, K, body, 0)


def cmpex_kernel(x_ref, out_ref):
    x = x_ref[...]
    for s in (1, 2, 4):
        y = pltpu.roll(x, s, 0)
        lo = jnp.minimum(x, y)
        hi = jnp.maximum(x, y)
        x = jnp.where((jax.lax.broadcasted_iota(
            jnp.int32, x.shape, 0) // s) % 2 == 0, lo, hi)
    out_ref[...] = x


# the one line of a copy that differs from its script: copy -> script
HIST_FIX = {"[0])": "[0].reshape(1, 128))"}
BODIES = [(gather_kernel, "radix_probe.py"), (gather_kernel,
                                               "radix_probe2.py"),
          (gather1_kernel, "radix_probe.py"), (hist_kernel, "radix_probe.py"),
          (copy_kernel, "radix_probe.py"), (cmpex_kernel, "radix_probe.py")]


@pytest.mark.parametrize("body,script", BODIES,
                         ids=[f"{b.__name__}-{s}" for b, s in BODIES])
def test_bodies_are_verbatim(body, script):
    """Each copied body is a run of consecutive lines of its script (up
    to indentation), hist_kernel's `.reshape(1, 128)` excepted."""
    with open(os.path.join(ROOT, "research", script)) as f:
        lines = [ln.strip() for ln in f]
    copy = [ln.strip() for ln in inspect.getsource(body).splitlines()]
    at = lines.index(copy[0])
    want = [HIST_FIX.get(ln, ln) if body is hist_kernel else ln
            for ln in copy]
    assert lines[at:at + len(copy)] == want
    if body is hist_kernel:
        assert sum(ln in HIST_FIX for ln in copy) == 1


def test_script_hist_body_fails_to_trace():
    """The fault the copy repairs: with the script's line, the body
    raises while tracing, so the reference can only print `hist FAIL`."""
    src = inspect.getsource(hist_kernel)
    scope = dict(jnp=jnp)
    exec(src.replace("[0])", "[0].reshape(1, 128))"), scope)
    x = jnp.zeros((2048, 128), jnp.int32)
    with pytest.raises(ValueError, match="fewer dimensions"):
        _blocked(scope["hist_kernel"], 2048, 2048, 8)(x)


# ---------------------------------------------------------------------------
# Plain versions against the bodies in interpret mode
# ---------------------------------------------------------------------------


def _i32(rng, shape):
    return rng.integers(-(1 << 31), 1 << 31, size=shape,
                        dtype=np.int64).astype(np.int32)


def _blocked(body, rows, n_rows, out_rows=None):
    """pl.pallas_call of `body` over (rows, 128) blocks, as the scripts
    launch it."""
    out_rows = out_rows or rows
    n_in = len(inspect.signature(body).parameters) - 1
    return pl.pallas_call(
        body, grid=(n_rows // rows,),
        in_specs=[pl.BlockSpec((rows, 128), lambda i: (i, 0))] * n_in,
        out_specs=pl.BlockSpec((out_rows, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(
            (n_rows // rows * out_rows, 128), jnp.int32),
        interpret=True)


def _no_launch(fn, *args):
    before = dict(RC.LAUNCHES)
    out = fn(*args)
    assert RC.LAUNCHES == before
    return out


@pytest.mark.parametrize("rows", [8, 32, 256, 1024, 4096, 8192])
def test_gather_rows_matches_gather_kernel(rows):
    rng = np.random.default_rng(rows)
    x = _i32(rng, (2 * rows, 128))
    idx = rng.integers(0, rows, size=x.shape, dtype=np.int32)
    want = np.asarray(_blocked(gather_kernel, rows, 2 * rows)(
        jnp.asarray(x), jnp.asarray(idx)))
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    np.testing.assert_array_equal(RC.gather_rows_ref(xt, it, rows).numpy(),
                                  want)
    np.testing.assert_array_equal(
        _no_launch(RC.gather_rows, xt, it, rows).numpy(), want)


def test_gather_lanes_matches_gather1_kernel():
    rng = np.random.default_rng(11)
    x = _i32(rng, (2048, 128))
    idx = rng.integers(0, 128, size=x.shape, dtype=np.int32)
    want = np.asarray(_blocked(gather1_kernel, 1024, 2048)(
        jnp.asarray(x), jnp.asarray(idx)))
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    np.testing.assert_array_equal(RC.gather_lanes_ref(xt, it).numpy(), want)
    np.testing.assert_array_equal(
        _no_launch(RC.gather_lanes, xt, it).numpy(), want)


def test_hist8_matches_fixed_hist_kernel():
    rng = np.random.default_rng(12)
    x = _i32(rng, (3 * 2048, 128))
    want = np.asarray(_blocked(hist_kernel, 2048, x.shape[0], 8)(
        jnp.asarray(x)))
    # the intended function: per tile and lane, the count of x & 7 == q
    tiles = (x & 7).reshape(3, 2048, 128)
    counts = np.stack([(tiles == q).sum(1) for q in range(8)], 1)
    np.testing.assert_array_equal(want, counts.reshape(24, 128))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(RC.hist8_ref(xt).numpy(), want)
    np.testing.assert_array_equal(_no_launch(RC.hist8, xt).numpy(), want)


HIST8_EDGES = ["one_digit", "negative", "every_digit"]


@pytest.mark.parametrize("kind", HIST8_EDGES)
def test_hist8_ref_edges(kind):
    """hist8_ref on research/hist8_ab.py's edge inputs against the counts
    by numpy: one digit filling each tile (a count of 2048 in one row),
    negative words, every digit once a lane."""
    x = H8.edge_inputs(2)[kind].astype(np.int32)
    tiles = (x & 0xFF).reshape(2, 2048, 128) % 8
    counts = np.stack([(tiles == q).sum(1) for q in range(8)], 1)
    got = RC.hist8_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, counts.reshape(16, 128))
    if kind == "one_digit":
        assert (got == 2048).sum() == 2 * 128
    if kind == "every_digit":
        assert (got[:, 0] == 32).sum() == 2 * 7


def test_hist8_ref_edges_match_hist_kernel():
    """The three edge inputs, a tile each, through the TPU body."""
    x = np.concatenate([H8.edge_inputs(1)[k] for k in HIST8_EDGES]
                       ).astype(np.int32)
    want = np.asarray(_blocked(hist_kernel, 2048, x.shape[0], 8)(
        jnp.asarray(x)))
    np.testing.assert_array_equal(RC.hist8_ref(torch.from_numpy(x)).numpy(),
                                  want)


def test_hist8_plan_covers_every_sm():
    """The probes' 20 tiles give 320 CTAs in clusters of 4, more than
    the H100's 132 SMs; 16-bit counters cover a CTA's 512 rows."""
    p = RC.hist8_plan(40960)
    assert p == dict(cluster=4, ctas=320, threads=256, rows_per_cta=512,
                     smem_bytes=17408)
    assert p["rows_per_cta"] < 1 << 16
    assert RC.hist8_plan(2048)["ctas"] == 16
    for rows in (1000, 2049, RC.MAX_ROWS + RC.TILE):
        with pytest.raises(ValueError):
            RC.hist8_plan(rows)
    with open(RC.LIB.src) as f:
        assert f"constexpr int kHistCluster = {RC.HIST8_CLUSTER};" in f.read()


def test_hist8_ab_variant_sources_rewrite_the_constants(tmp_path,
                                                       monkeypatch):
    """Each build of the design sweep is the source with its own cluster
    size, batch and load, and nothing else changed."""
    monkeypatch.setattr(H8, "BUILD_DIR", str(tmp_path))
    with open(RC.LIB.src) as f:
        src = f.read()
    for batch, load in H8.LOADS:
        for cluster in H8.CLUSTERS:
            with open(H8._variant_source(batch, load, cluster)) as f:
                got = f.read()
            assert f"constexpr int kHistBatch = {batch};" in got
            assert f"constexpr int kHistCluster = {cluster};" in got
            assert got.count(f"{load}(src") == src.count(
                f"{H8.SOURCE[1]}(src") == 2
            back = got.replace(f"kHistBatch = {batch};",
                               f"kHistBatch = {H8.SOURCE[0]};").replace(
                f"kHistCluster = {cluster};",
                f"kHistCluster = {RC.HIST8_CLUSTER};").replace(
                f"{load}(src", f"{H8.SOURCE[1]}(src")
            assert back == src


def test_run_copy_matches_copy_kernel_on_copied_rows():
    rng = np.random.default_rng(13)
    rows = 512
    src = _i32(rng, (rows, 128))
    offs = rng.integers(0, rows - C, size=(K,), dtype=np.int32)
    cpy = pl.pallas_call(
        copy_kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.ANY),
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.int32),
        scratch_shapes=[pltpu.SemaphoreType.DMA],
        compiler_params=pltpu.CompilerParams(has_side_effects=True),
        interpret=True)
    want = np.asarray(cpy(jnp.asarray(offs), jnp.asarray(src)))
    covered = np.zeros(rows, bool)
    for o in offs:
        covered[o:o + C] = True
    assert 0 < covered.sum() < rows
    st, ot = torch.from_numpy(src), torch.from_numpy(offs)
    for fn in (RC.run_copy_ref, RC.run_copy):
        dst = torch.zeros_like(st)
        got = _no_launch(fn, st, dst, ot, C).numpy()
        np.testing.assert_array_equal(got[covered], want[covered])
        assert not got[~covered].any()   # rows no run covers keep dst's


@pytest.mark.parametrize("value_range", ["full", "narrow"])
def test_cmpex3_matches_cmpex_kernel(value_range):
    rng = np.random.default_rng(14)
    x = _i32(rng, (3 * 2048, 128))
    if value_range == "narrow":   # many ties
        x = (x % 5).astype(np.int32)
    x[0, :4] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1, 0]
    want = np.asarray(_blocked(cmpex_kernel, 2048, x.shape[0])(
        jnp.asarray(x)))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(RC.cmpex3_ref(xt).numpy(), want)
    np.testing.assert_array_equal(_no_launch(RC.cmpex3, xt).numpy(), want)


def test_wrappers_reject_bad_tensors():
    x = torch.zeros((2048, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        RC.gather_rows(x, x, 3)          # rows not a multiple of R
    with pytest.raises(ValueError):
        RC.gather_lanes(x, x.long())     # index not int32
    with pytest.raises(ValueError):
        RC.hist8(x[:1024])               # not whole tiles
    with pytest.raises(ValueError):
        RC.cmpex3(x.view(4096, 64))      # not 128 lanes
    with pytest.raises(ValueError):
        RC.cmpex3(torch.zeros((128, 2048), dtype=torch.int32).t())
    with pytest.raises(ValueError):
        RC.run_copy(x, x, torch.zeros(4, dtype=torch.int64), 16)


# ---------------------------------------------------------------------------
# The probes' entry points on the CPU
# ---------------------------------------------------------------------------


def test_sort_by_v0v1_orders_unsigned_keys():
    """P1's and Q3's two-key sort: stable, by unsigned (v0, v1), also
    where v0's int32 bit pattern is negative."""
    rng = np.random.default_rng(15)
    v0 = rng.choice(np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]),
                    size=2000)
    v1 = rng.integers(0, 3, size=2000) * 0x7FFFFFFF
    got = F._sort_by_v0v1([torch.from_numpy(v0), torch.from_numpy(v1)])
    order = np.lexsort((v1, v0))   # stable, last key major
    np.testing.assert_array_equal(got[2].numpy(), order)
    np.testing.assert_array_equal(got[0].numpy(),
                                  v0[order].astype(np.uint32).view(np.int32))


P1_KEYS = {"sort_1k_1p_ms", "sort_1k_3p_ms", "sort_2k_3p_ms",
           "gather_ax0_R1024_ms", "gather_ax0_R4096_ms",
           "gather_ax0_R8192_ms", "gather_ax1_ms", "hist256_ms",
           "dma_2048x8KB_ms", "dma_per_copy_us", "cmpex_3stage_ms",
           "cmpex_per_stage_ms"}


@pytest.fixture
def chain_calls(monkeypatch):
    """Each chain_time call of a probe's run as (its result, the two
    one-call legs it timed)."""
    calls, legs = [], []
    leg_ms, chain_time = RP._leg_ms, RP.chain_time

    def spy_leg(fn, dev):
        legs.append(leg_ms(fn, dev))
        return legs[-1]

    def spy(step, x0, dev, reps=RP.CHAIN):
        legs.clear()
        ms = chain_time(step, x0, dev, reps)
        calls.append((ms, legs[0::2]))   # legs: one, chain, one, chain
        return ms

    monkeypatch.setattr(RP, "_leg_ms", spy_leg)
    for mod in (RP, RP2):
        monkeypatch.setattr(mod, "chain_time", spy)
    return calls


def _check_times(res, calls, n_calls):
    """Every time is a finite float; each chain_time result is (chain -
    one) / 6 at its best, so no less than -(its slower one-call leg) / 6
    however the host clock stalls."""
    assert all(isinstance(v, float) and math.isfinite(v)
               for v in res.values())
    assert len(calls) == n_calls
    for ms, ones in calls:
        assert len(ones) == 2 and ms >= -max(ones) / (RP.CHAIN - 1)


def test_radix_probe_runs_on_cpu_without_launching(chain_calls):
    data = make_corpus(1, SEED)
    before = dict(RC.LAUNCHES)
    res = RP.run(data, device="cpu")
    assert RC.LAUNCHES == before
    assert set(res) == P1_KEYS
    _check_times(res, chain_calls, 10)
    assert res["dma_per_copy_us"] == pytest.approx(
        res["dma_2048x8KB_ms"] / RP.RUNS * 1e3)


def test_radix_probe2_runs_on_cpu_without_launching(chain_calls):
    data = make_corpus(1, SEED)[:1 << 18]
    before = dict(RC.LAUNCHES), dict(F.LAUNCHES)
    res = RP2.run(data, device="cpu")
    assert (dict(RC.LAUNCHES), dict(F.LAUNCHES)) == before
    assert set(res) == {
        "gather_ax0_R8_ms", "gather_ax0_R32_ms", "gather_ax0_R256_ms",
        "segsort_8x32K_ms", "segsort_64x4K_ms", "leg_prep_ms",
        "leg_sort8_ms", "leg_fold8_ms", "leg_sort_short_ms",
        "leg_fold_short_ms", "whole_exact9_ms"}
    _check_times(res, chain_calls, 11)


@pytest.mark.parametrize("feeds", [True, False])
def test_chain_time_is_the_references_method(monkeypatch, feeds):
    """One warm call, then twice one call from x0 and a chain of 7 in
    which each output is the next input (or, for a step that ignores its
    input, step(x0) repeated); per call (chain - one) / 6, the best of
    the two rounds, in ms.  Each clock read costs 0.5 s, which the
    subtraction cancels; calls of the first round cost 3 ms, of the
    second 2 ms."""
    clock = [0.0]

    def read():
        clock[0] += 0.5
        return clock[0]

    seen = []

    def step(x):
        seen.append(int(x[0]))
        clock[0] += 0.003 if len(seen) <= 9 else 0.002
        return x + 1

    monkeypatch.setattr(RP.time, "perf_counter", read)
    x0 = torch.zeros(4, dtype=torch.int32)
    fn = step if feeds else RP.fixed_step(lambda: step(x0))
    ms = RP.chain_time(fn, x0, torch.device("cpu"))
    assert ms == pytest.approx(2.0)
    chain = list(range(7)) if feeds else [0] * 7
    assert seen == [0] + ([0] + chain) * 2
    with pytest.raises(ValueError):
        RP.chain_time(fn, x0, torch.device("cpu"), reps=1)


# the six probe sites at the probes' [40960, 128]: the route, its strip
# width and R-blocks a CTA, its grid
SITES = {8: ("smem", 128, 16, (320, 1)), 32: ("smem", 128, 4, (320, 1)),
         256: ("smem", 64, 1, (320, 1)), 1024: ("smem", 16, 1, (320, 1)),
         4096: ("l2", 128, 1, (512, 10)), 8192: ("l2", 128, 1, (1024, 5))}


@pytest.mark.parametrize("r", sorted(SITES))
def test_gather_rows_plan_at_the_sites(r):
    """A staged strip is 64 KiB a CTA in 320 CTAs (3 CTAs an SM fill 132
    SMs in one wave); the l2 route stages nothing, a thread an int4."""
    p = RC.gather_rows_plan(40960, r)
    assert (p["route"], p["lanes"], p["blocks_per_cta"], p["grid"]) == \
        SITES[r]
    assert p["ctas"] == p["grid"][0] * p["grid"][1]
    assert p["smem_bytes"] == (65536 if p["route"] == "smem" else 0)


@pytest.mark.parametrize("rows,r", [(40960, 3), (40960, 0), (0, 8),
                                    (RC.MAX_ROWS + 128, 128)])
def test_gather_rows_plan_refuses_a_shape_it_cannot_take(rows, r):
    with pytest.raises(ValueError):
        RC.gather_rows_plan(rows, r)


@pytest.mark.parametrize("rows,r,route", [
    (16384, 1, "smem"), (16392, 24, "smem"), (20004, 5001, "l2"),
    (40960, 40960, "l2"), (24000, 12000, "l2"), (8, 8, "smem"),
    (16384, 2048, "smem"), (24576, 3, "smem"), (40960, 40, "smem"),
    (40960, 2560, "l2"), (RC.MAX_ROWS, 1, "smem"),
    (RC.MAX_ROWS, 4096, "l2")])
def test_gather_rows_plan_routes(rows, r, route):
    """The route follows R alone; a strip never passes 64 KiB, the CTAs
    cover every R-block and lane, and the grid fits the card's limits
    (2^31 - 1 CTAs along x, 65,535 along y) up to the most rows the
    kernels take."""
    p = RC.gather_rows_plan(rows, r)
    assert p["route"] == route
    assert p["smem_bytes"] <= 65536
    gx, gy = p["grid"]
    assert gx < 1 << 31 and gy <= 65535 and p["ctas"] == gx * gy
    n_blocks = rows // r
    if route == "smem":
        assert r * p["lanes"] <= RC.STRIP and p["lanes"] >= 8
        assert gy == 1 and p["smem_bytes"] == \
            p["blocks_per_cta"] * r * p["lanes"] * 4
        assert gx * p["blocks_per_cta"] * p["lanes"] >= n_blocks * 128
    else:
        assert gy == n_blocks and gx * 256 >= r * 32


def test_gather_lanes_plan_strides_past_eight_ctas_an_sm():
    assert RC.gather_lanes_plan(1001, 132)["ctas"] == 32
    assert RC.gather_lanes_plan(40960, 132)["ctas"] == 8 * 132


def test_probe_inputs_follow_the_reference_seeds():
    """P2's indices and P4's offsets are the reference script's draws."""
    data = make_corpus(1, SEED)
    ins = RP.inputs(data, torch.device("cpu"))
    rows = len(data) // 128
    np.testing.assert_array_equal(
        ins["idx"][1024].numpy(), np.random.default_rng(0).integers(
            0, 1024, size=(rows, 128), dtype=np.int32))
    np.testing.assert_array_equal(
        ins["idx"][8192].numpy(), np.random.default_rng(1).integers(
            0, 8192, size=(rows, 128), dtype=np.int32))
    np.testing.assert_array_equal(
        ins["offs"].numpy(), np.random.default_rng(3).integers(
            0, rows - 16, size=(2048,), dtype=np.int32))
    b = np.frombuffer(data, np.uint8).astype(np.uint32)
    v0 = b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)
    np.testing.assert_array_equal(ins["x"].numpy().ravel()[:-3],
                                  v0.view(np.int32))


@pytest.mark.parametrize("mib,digest", [
    (1, "11c43624953d7bf999b0604015bc340c68e60a7efd810172fbe9c96bb8946845"),
    (5, "18e9c38aa009915f3523cfdd91448b85e6f19eb3032726ce5b25f67cf58d9d25")])
def test_corpus_is_the_same_at_every_commit(mib, digest):
    """make_corpus gives the bytes chip_smoke.py has run on since the
    port began (its 5 MiB is the probes' input)."""
    assert hashlib.sha256(make_corpus(mib, SEED)).hexdigest() == digest


def test_gather_ab_times_the_probes_gather_sites():
    """research/gather_ab.py holds old and new gathers to the probes'
    seven sites on the probes' own inputs: R = 8, 32, 256 indexed as
    radix_probe2 draws them, 1024, 4096, 8192 and the lanes as
    radix_probe does."""
    data = make_corpus(GA.MIB, SEED)
    ins = RP.inputs(data, torch.device("cpu"))
    got = GA.sites(torch.device("cpu"))
    assert [(n, r) for n, _, _, r in got] == \
        [(f"gather_rows R={r}", r) for r in (8, 32, 256, 1024, 4096, 8192)] \
        + [("gather_lanes", None)]
    for name, x, idx, r in got:
        assert torch.equal(x, ins["x"]) and x.shape == (40960, 128)
        want = ins["idx_lanes"] if r is None else ins["idx"][r] \
            if r in RP.GATHER_ROWS else RP.block_index(40960, r, r, x.device)
        assert torch.equal(idx, want), name


def test_gather_ab_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        GA.main(["--old", "radix_probe.cu"])


def test_probes_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = bytes(1 << 20)
    for run in (RP.run, RP2.run):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(data)
