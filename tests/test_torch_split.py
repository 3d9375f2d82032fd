"""brotli_tpu_torch's device block-split planner against brotli_tpu's.

The Lloyd loop runs on CPU tensors in the port and under jit on the
JAX CPU backend.  `assign` decides output bytes and must be equal.
`cost` is compared to rtol=1e-5: both sides work in float32, but
log2 and the matmul's summation order come from different libraries
(XLA vs PyTorch), so the last bits may differ.  The linspace seeds
must be equal for every (nch, k) the path can produce.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brotli_tpu.ops import split as JS
from brotli_tpu_torch.ops import split as TS
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _path_pairs():
    """(padded chunk count, k) for every literal count up to 2^24: k =
    min(32, nch // 3) for nch real chunks, padded up to a power of 2."""
    pairs = set()
    for nch in range(6, 1 << 16):
        k = min(32, max(1, nch // 3), 256)
        pairs.add((1 << max(2, (nch - 1).bit_length()), k))
    return sorted(pairs)


def test_linspace_seeds_match_jax():
    pairs = _path_pairs()
    assert len(pairs) > 40

    @jax.jit
    def seeds_for(shape_carrier, k_carrier):
        nch, k = shape_carrier.shape[0], k_carrier.shape[0]
        return jnp.linspace(0, nch, k + 1).astype(jnp.int32)

    for nch, k in pairs:
        want = np.asarray(seeds_for(jnp.zeros(nch), jnp.zeros(k)))
        np.testing.assert_array_equal(TS.linspace_seeds(nch, k), want,
                                      err_msg=f"nch={nch} k={k}")


def _literals(n: int, seed: int) -> np.ndarray:
    """A literal stream whose byte distribution drifts in segments,
    so the clustering has real structure to find."""
    rng = np.random.default_rng(seed)
    out = []
    while sum(len(x) for x in out) < n:
        lo = int(rng.integers(0, 200))
        width = int(rng.integers(4, 56))
        seg = rng.integers(lo, lo + width, size=int(rng.integers(300, 3000)))
        out.append(seg)
    return np.concatenate(out)[:n].astype(np.int64)


@pytest.mark.parametrize("n", [1600, 9000, 70000, 300000])
def test_lloyd_matches_jax(n):
    p = TS.SPLIT_PARAMS["literal"]
    chunk = p["chunk"]
    nch = (n + chunk - 1) // chunk
    k = int(min(p["max_types"], max(1, nch // 3), 256))
    nch_pad = 1 << max(2, (nch - 1).bit_length())
    syms = _literals(n, seed=n)
    padded = np.concatenate([syms.astype(np.int32),
                             np.full(nch_pad * chunk - n, -1, np.int32)])
    pen = p["switch_cost"] / max(1, chunk // 16)
    ja, jc = JS._lloyd_device(jnp.asarray(padded), 256, k, chunk, 3, pen)
    ta, tc = TS._lloyd_device(torch.from_numpy(padded), 256, k, chunk, 3,
                              pen)
    assert ta.dtype == torch.int32 and tc.dtype == torch.float32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)
    assert len(np.unique(ta.numpy()[:nch])) > 1


@pytest.mark.parametrize("n", [100, 700, 20000, 131072])
def test_split_symbols_device_matches_jax(n):
    syms = _literals(n, seed=3 * n)
    want = JS.split_symbols_device(syms, 256, "literal")
    got = TS.split_symbols_device(syms, 256, "literal",
                                  device=torch.device("cpu"))
    assert got.num_types == want.num_types
    np.testing.assert_array_equal(got.types, want.types)
    assert got.blocks == want.blocks


# -- the host planning: the merge and the hysteresis -------------------------


def _drift_hist(nch: int, alpha: int, seed: int) -> np.ndarray:
    """Chunk histograms of drifting symbol segments (whole counts)."""
    rng = np.random.default_rng(seed)
    hist = np.zeros((nch, alpha))
    for c in range(nch):
        lo = int(rng.integers(0, alpha - 4))
        syms = rng.integers(lo, min(alpha, lo + int(rng.integers(2, 40))),
                            size=int(rng.integers(1, 256)))
        hist[c] = np.bincount(syms, minlength=alpha)
    return hist


def _merge_cases():
    """(assign, hist, k, header_cost) for the merge: m = 1, 2 and 32,
    duplicate type histograms (tied deltas), all-zero rows, a merge
    that stops at once and one down to one type, seeded literal,
    command and distance sizes."""
    rng = np.random.default_rng(2301)
    cases = {}
    h = _drift_hist(40, 256, 1)
    cases["m1"] = (np.zeros(40, np.int64), h, 4, 320.0)
    cases["m2"] = (np.repeat([3, 1], 20), h, 4, 320.0)
    cases["m32"] = (np.arange(96) % 32, _drift_hist(96, 256, 2), 32, 320.0)
    cases["m32_shuffled"] = (rng.permutation(np.arange(96) % 32),
                             _drift_hist(96, 256, 3), 32, 320.0)
    dup = _drift_hist(12, 256, 4)
    hd = np.concatenate([dup, dup, dup])       # types 0-11, 12-23, 24-35
    cases["duplicate_rows"] = (np.arange(36), hd, 36, 320.0)
    cases["duplicate_rows_one_row"] = (
        np.arange(16), np.tile(dup[:1], (16, 1)), 16, 320.0)
    # three one-symbol types of 4 counts: every pair's delta is 8 - 10
    # exactly, and after the first merge the next pair costs more than
    # it saves, so the row-major order of the tie decides the result
    ht = np.zeros((6, 256))
    ht[[0, 3], 0] = ht[[1, 4], 1] = ht[[2, 5], 2] = 2.0
    cases["tied_pairs"] = (np.arange(6) % 3, ht, 3, 10.0)
    hz = _drift_hist(30, 256, 5)
    hz[::3] = 0.0
    cases["zero_rows"] = (np.arange(30) % 10, hz, 10, 320.0)
    cases["all_zero"] = (np.arange(20) % 5, np.zeros((20, 256)), 5, 320.0)
    cases["stops_at_once"] = (np.arange(64) % 16, _drift_hist(64, 256, 6),
                              16, -1e9)
    cases["to_one_type"] = (np.arange(64) % 16, _drift_hist(64, 256, 7),
                            16, 1e12)
    for i, (alpha, k, hc) in enumerate([
            (256, 32, 320.0), (704, 16, 500.0), (64, 8, 600.0),
            (256, 32, 1280.0), (704, 16, 2000.0), (64, 8, 600.0),
            (256, 32, 1280.0), (704, 16, 8000.0), (64, 8, 600.0)]):
        nch = int(rng.integers(3 * k, 600))
        assign = rng.integers(0, k, nch)
        assign[rng.random(nch) < 0.5] = int(rng.integers(0, k))
        cases[f"seeded{i}_{alpha}"] = (assign, _drift_hist(nch, alpha,
                                                           10 + i), k, hc)
    return cases


MERGE_CASES = _merge_cases()


@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_merge_types_matches_jax(name):
    from brotli_tpu.encode import metablock as JM
    from brotli_tpu_torch.encode import metablock as TM
    assign, hist, k, header_cost = MERGE_CASES[name]
    want = JM._merge_types(assign.copy(), hist.copy(), k, 28.1, header_cost)
    got = TM._merge_types(assign.copy(), hist.copy(), k, 28.1, header_cost)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if name == "stops_at_once":
        np.testing.assert_array_equal(got, assign)
    if name == "tied_pairs":
        np.testing.assert_array_equal(got, [0, 0, 2, 0, 0, 2])
    if name == "to_one_type":
        assert len(np.unique(got)) == 1
    if name.startswith("seeded"):
        assert 1 < len(np.unique(got)) < len(np.unique(assign))


def _hysteresis_cases():
    """(assign, cost, min_run): runs of 1 and 2 at the first and last
    position, cp == cn ties, one run, no run at all, an assignment
    that takes all 4 passes, seeded cases with and without ties."""
    rng = np.random.default_rng(2302)
    cases = {}
    c5 = rng.random((12, 5)) * 100
    cases["first_run_of_1"] = (np.array([2] + [0] * 5 + [1] * 6), c5, 3)
    cases["first_run_of_2"] = (np.array([2] * 2 + [0] * 4 + [1] * 6), c5, 3)
    cases["last_run_of_1"] = (np.array([0] * 6 + [1] * 5 + [4]), c5, 3)
    cases["last_run_of_2"] = (np.array([0] * 6 + [1] * 4 + [4] * 2), c5, 3)
    cases["both_ends_short"] = (np.array([3, 0, 0, 0, 1, 2, 2, 2, 2, 4, 4,
                                          1]), c5, 3)
    cases["ties"] = (np.array([0] * 4 + [1] + [2] * 4 + [3, 3] + [0] * 3),
                     np.ones((14, 5)), 3)
    tie_cols = rng.random((14, 1)).repeat(5, axis=1)
    cases["ties_by_column"] = (cases["ties"][0], tie_cols, 3)
    cases["one_run"] = (np.full(9, 4), c5[:9], 3)
    cases["one_short_run"] = (np.full(2, 4), c5[:2], 3)
    cases["empty"] = (np.zeros(0, np.int64), np.zeros((0, 5)), 3)
    # every run of 1 takes the previous run's type at a tie, so the
    # three types rotate and every pass changes something
    cases["four_passes"] = (np.arange(15) % 3, np.zeros((15, 3)), 3)
    for i in range(12):
        n, k = int(rng.integers(2, 300)), int(rng.integers(2, 9))
        assign = rng.integers(0, k, n)
        cost = rng.random((n, k)) * 50
        if i % 3 == 0:
            cost = np.round(cost / 10)          # many cp == cn
        if i % 4 == 1:
            assign = np.repeat(assign, rng.integers(1, 5, n))[:n]
        cases[f"seeded{i}"] = (assign, cost[:len(assign)], 3)
    return cases


HYSTERESIS_CASES = _hysteresis_cases()


@pytest.mark.parametrize("name", list(HYSTERESIS_CASES))
def test_hysteresis_matches_jax(name, monkeypatch):
    from brotli_tpu.encode import metablock as JM
    from brotli_tpu_torch.encode import metablock as TM
    assign, cost, min_run = HYSTERESIS_CASES[name]
    passes = []
    runs = JM._runs
    monkeypatch.setattr(JM, "_runs", lambda t: passes.append(1) or runs(t))
    want = JM._hysteresis(assign.copy(), cost, min_run)
    got = TM._hysteresis(assign.copy(), cost, min_run)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if name == "four_passes":
        assert len(passes) == 4 and not np.array_equal(got, assign)
    if name.startswith("one_"):
        np.testing.assert_array_equal(got, assign)


def test_split_symbols_device_random_bytes_matches_jax(monkeypatch):
    """524,288 uniform bytes: 2,048 chunks at k = 32.  Their chunks'
    costs nearly tie, and the two libraries' float32 Lloyd loops assign
    21 of the 2,048 chunks apart, so the JAX side is handed the port's
    Lloyd result: the host halves (the hysteresis, the histograms, the
    merge, the relabelling) are compared at this size."""
    def port_lloyd(padded, *args):
        a, c = TS._lloyd_device(torch.from_numpy(np.asarray(padded)), *args)
        return a.numpy(), c.numpy()

    syms = np.random.default_rng(2303).integers(0, 256, 1 << 19)
    monkeypatch.setattr(JS, "_lloyd_device", port_lloyd)
    want = JS.split_symbols_device(syms, 256, "literal")
    assert want.num_types > 16
    got = TS.split_symbols_device(syms, 256, "literal",
                                  device=torch.device("cpu"))
    assert got.num_types == want.num_types
    np.testing.assert_array_equal(got.types, want.types)
    assert got.blocks == want.blocks


def _symbols(n: int, alpha: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = []
    while sum(len(x) for x in out) < n:
        lo = int(rng.integers(0, alpha - 8))
        out.append(rng.integers(lo, min(alpha, lo + int(rng.integers(2, 40))),
                                size=int(rng.integers(50, 2000))))
    return np.concatenate(out)[:n].astype(np.int64)


@pytest.mark.parametrize("category,alpha,n", [
    ("command", 704, 5000), ("command", 704, 40000),
    ("distance", 64, 3000), ("distance", 64, 30000)])
def test_split_symbols_matches_jax(category, alpha, n):
    from brotli_tpu.encode import metablock as JM
    from brotli_tpu_torch.encode import metablock as TM
    syms = _symbols(n, alpha, seed=n + alpha)
    want = JM.split_symbols(syms, alpha, category)
    got = TM.split_symbols(syms, alpha, category)
    assert got.num_types == want.num_types > 1
    np.testing.assert_array_equal(got.types, want.types)
    assert got.blocks == want.blocks
