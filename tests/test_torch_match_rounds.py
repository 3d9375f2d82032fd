"""brotli_tpu_torch's match-length round chain against brotli_tpu's.

match_rounds_ref (what the CUDA kernel is held to on the card) against
the Pallas kernel match_rounds_pallas in interpret mode, and the
port's match_lengths_blocked / match_lengths_capped against both JAX
functions.  Inputs come from a numpy seed; every length 0..4R is
planted.  Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brotli_tpu.ops import matching as JM
from brotli_tpu.ops.pallas_match import match_lengths_blocked as jblocked
from brotli_tpu.ops.pallas_match import match_rounds_pallas
from brotli_tpu_torch.ops import match_rounds_cuda as MR
from brotli_tpu_torch.ops import matching as TM
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _planted(rounds: int, m: int, seed: int):
    """va, vb uint32 [rounds, m] whose candidate i shares exactly
    i % (4 * rounds + 1) leading bytes; the rounds after the first
    unequal one are equal again, so a chain that forgot to stop would
    count them."""
    rng = np.random.default_rng(seed)
    va = rng.integers(0, 1 << 32, size=(rounds, m), dtype=np.uint64)
    vb = va.copy()
    length = np.arange(m) % (4 * rounds + 1)
    cut = length < 4 * rounds
    r, byte = length[cut] // 4, length[cut] % 4
    flip = rng.integers(1, 256, size=int(cut.sum()), dtype=np.uint64)
    vb[r, np.nonzero(cut)[0]] ^= flip << (8 * byte).astype(np.uint64)
    return va.astype(np.uint32), vb.astype(np.uint32), length


@pytest.mark.parametrize("m", [1024, 3072])
@pytest.mark.parametrize("rounds", [1, 4, 8])
def test_match_rounds_ref_matches_pallas(rounds, m):
    va, vb, length = _planted(rounds, m, seed=rounds * m)
    assert (va >= 1 << 31).any()
    want = np.asarray(match_rounds_pallas(jnp.asarray(va), jnp.asarray(vb),
                                          interpret=True))
    got = MR.match_rounds(torch.from_numpy(va.view(np.int32)),
                          torch.from_numpy(vb.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), length)


def test_match_rounds_cpu_launches_nothing():
    va, vb, _ = _planted(8, 1024, seed=1)
    before = dict(MR.LAUNCHES)
    MR.match_rounds(torch.from_numpy(va.view(np.int32)),
                    torch.from_numpy(vb.view(np.int32)))
    assert MR.LAUNCHES == before
    with pytest.raises(ValueError):
        MR.match_rounds(torch.zeros(2, 8, dtype=torch.int64),
                        torch.zeros(2, 8, dtype=torch.int64))


def _text(n: int, seed: int) -> np.ndarray:
    """A 37-byte block repeated, with 3% of the bytes replaced."""
    rng = np.random.default_rng(seed)
    data = np.tile(rng.integers(0, 256, 37, dtype=np.uint8), n // 37 + 1)
    noise = rng.random(len(data)) < 0.03
    data[noise] = rng.integers(0, 256, int(noise.sum()), dtype=np.uint8)
    return data[:n]


@pytest.mark.parametrize("limit_value", [32, 13])
def test_match_lengths_match_jax(limit_value):
    data = _text(30000, seed=5)
    rng = np.random.default_rng(3)
    m = 2000
    b = rng.integers(100, len(data) - 200, m).astype(np.int32)
    # period multiples (long matches, cut by the noise) and others
    dist = np.where(rng.random(m) < 0.7, 37 * rng.integers(1, 3, m),
                    rng.integers(1, 90, m))
    a = (b - dist).astype(np.int32)
    limit = np.full(m, limit_value, np.int32)
    v4_j = JM.u32_values(jnp.asarray(data))
    want_capped = np.asarray(JM.match_lengths_capped(
        v4_j, jnp.asarray(a), jnp.asarray(b), jnp.asarray(limit)))
    want_blocked = np.asarray(jblocked(
        v4_j, jnp.asarray(a), jnp.asarray(b), jnp.asarray(limit),
        interpret=True))
    v4 = TM.u32_values(torch.from_numpy(data))
    ta, tb, tl = (torch.from_numpy(x) for x in (a, b, limit))
    got_blocked = MR.match_lengths_blocked(v4, ta, tb, tl)
    got_capped = TM.match_lengths_capped(v4, ta, tb, tl)
    np.testing.assert_array_equal(got_blocked.numpy(), want_blocked)
    np.testing.assert_array_equal(got_blocked.numpy(), want_capped)
    np.testing.assert_array_equal(got_capped.numpy(), want_capped)
    # lengths at the limit and below 4 both occur
    assert (want_capped == limit_value).any() and (want_capped < 4).any()


# ---------------------------------------------------------------------------
# The fold form: match_rounds_shifted(va, k)
# ---------------------------------------------------------------------------


def _chained(rounds: int, m: int, seed: int):
    """va uint32 [rounds, m] whose row i shares exactly i % (4 * rounds
    + 1) leading bytes with row i - 1 (rows further left share what
    follows from that), and row 0 has two zero words and a word with two
    zero low bytes first, so that against the zero halo it counts 10
    bytes (rounds >= 3).  Returns va and the planted lengths."""
    rng = np.random.default_rng(seed)
    va = np.zeros((rounds, m), np.uint64)
    col = rng.integers(0, 1 << 32, size=rounds, dtype=np.uint64)
    col[:min(rounds, 3)] = [0, 0, 0xAB0000][:min(rounds, 3)]
    va[:, 0] = col
    length = np.arange(m) % (4 * rounds + 1)
    for i in range(1, m):
        col = col.copy()
        if length[i] < 4 * rounds:
            r, byte = divmod(int(length[i]), 4)
            col[r] ^= np.uint64(int(rng.integers(1, 256)) << (8 * byte))
            # the rounds after the first unequal one change too, or stay
            col[r + 1:] ^= rng.integers(0, 2, size=rounds - r - 1,
                                        dtype=np.uint64) \
                * rng.integers(0, 1 << 32, size=rounds - r - 1,
                               dtype=np.uint64)
        va[:, i] = col
    return va.astype(np.uint32), length


def _pallas_shifted(va: np.ndarray, j: int) -> np.ndarray:
    """match_rounds_pallas(va, va shifted by j) in interpret mode, M
    padded to its block of 1024 as match_lengths_blocked pads."""
    m = va.shape[1]
    vb = np.zeros_like(va)
    if j < m:
        vb[:, j:] = va[:, :m - j]
    pad = ((0, 0), (0, (-m) % 1024))
    return np.asarray(match_rounds_pallas(
        jnp.asarray(np.pad(va, pad)), jnp.asarray(np.pad(vb, pad)),
        interpret=True))[:m]


@pytest.mark.parametrize("m", [1, 31, 33, 1000, 3072])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_match_rounds_shifted_ref_matches_pallas(k, m):
    va, length = _chained(8, m, seed=k * 7919 + m)
    before = dict(MR.LAUNCHES)
    got = MR.match_rounds_shifted(torch.from_numpy(va.view(np.int32)), k)
    assert MR.LAUNCHES == before
    assert got.dtype == torch.int32 and got.shape == (k, m)
    for j in range(1, k + 1):
        np.testing.assert_array_equal(got[j - 1].numpy(),
                                      _pallas_shifted(va, j))
    # offset 1 carries the planted lengths; row 0 (and every row
    # i < j) runs against the zero halo: 4 + 4 + 2 bytes at row 0
    np.testing.assert_array_equal(got[0, 1:].numpy(), length[1:])
    assert (got[:, 0] == 10).all()
    if m >= 1000:
        assert set(length[1:]) == set(range(33))


@pytest.mark.parametrize("k", [1, 2, 8])
def test_match_rounds_shifted_equals_two_operand_ref(k):
    va, vb, _ = _planted(8, 1024, seed=k)
    w = torch.from_numpy(va.view(np.int32))
    got = MR.match_rounds_shifted(w, k)
    for j in range(1, k + 1):
        assert torch.equal(got[j - 1],
                           MR.match_rounds(w, MR.shift_rounds(w, j)))


def test_match_rounds_shifted_rejects():
    w = torch.zeros(8, 64, dtype=torch.int32)
    for k in (0, 9, 2.0):
        with pytest.raises(ValueError):
            MR.match_rounds_shifted(w, k)
    with pytest.raises(ValueError):
        MR.match_rounds_shifted(w.long(), 1)
    with pytest.raises(ValueError):
        MR.match_rounds_shifted(w[0], 1)
    # M >= 2^31 raises before any data is read (a stride-0 view)
    huge = torch.zeros(1, 1, dtype=torch.int32).expand(1, 1 << 31)
    with pytest.raises(ValueError):
        MR.match_rounds_shifted(huge, 1)


@pytest.mark.parametrize("m", [1, 255, 256, 257, 4_194_304, (1 << 31) - 1])
def test_match_rounds_plan_covers_every_row_once(m):
    plan = MR.match_rounds_plan(m)
    assert plan["threads"] == MR.THREADS
    assert plan["ctas"] * plan["threads"] >= m
    assert (plan["ctas"] - 1) * plan["threads"] < m


@pytest.mark.parametrize("m", [0, 1 << 31])
def test_match_rounds_plan_rejects(m):
    with pytest.raises(ValueError):
        MR.match_rounds_plan(m)


@pytest.mark.parametrize("k,k8,min_pos", [(2, 1, 0), (8, 4, 0), (3, 2, 5000)])
def test_fold_sorted_one_launch_per_fold_matches_jax(monkeypatch, k, k8,
                                                     min_pos):
    """best_matches_block (its _fold_sorted folds) equals the JAX
    package's on _text data, and each fold takes its lengths from one
    call of the fold form, never from the two-operand form."""
    data = _text(20000, seed=k * 10 + k8)
    window = (1 << 14) - 16
    calls = []
    shifted = MR.match_rounds_shifted

    def spy(va, kk):
        calls.append((tuple(va.shape), kk))
        return shifted(va, kk)

    def no_two_operand(va, vb):
        raise AssertionError("_fold_sorted ran the two-operand form")

    monkeypatch.setattr(MR, "match_rounds_shifted", spy)
    monkeypatch.setattr(MR, "match_rounds", no_two_operand)
    got = TM.best_matches_block(torch.from_numpy(data), window, k=k, k8=k8,
                                min_pos=min_pos)
    assert calls == [((8, len(data)), k), ((8, len(data)), k8)]
    want = JM.best_matches_block(jnp.asarray(data), window, k=k, k8=k8,
                                 min_pos=min_pos)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() >= 4).sum() > len(data) // 4


@pytest.mark.parametrize("variant", [(1, 1, 64), (4, 8, 256)])
def test_design_sweep_builds_its_variants_from_the_source(variant, tmp_path,
                                                          monkeypatch):
    """research/design_sweep.py rewrites the kernel's constants by text:
    each variant differs from csrc/match_rounds.cu in exactly those."""
    from brotli_tpu_torch.research import design_sweep as DS
    monkeypatch.setattr(DS, "BUILD_DIR", str(tmp_path))
    assert DS.MR_VARIANTS[0] == (2, 4, MR.THREADS)
    two, fold, threads = variant
    with open(MR.LIB.src) as f:
        src = f.read().splitlines()
    with open(DS._variant_source(*variant)) as f:
        got = f.read().splitlines()
    changed = [(a, b) for a, b in zip(src, got) if a != b]
    assert len(src) == len(got) and len(changed) == 2
    assert changed[0][1].startswith(f"constexpr int THREADS = {threads};")
    assert changed[1][1] == (f"constexpr int TWO_BATCH = {two}, "
                             f"FOLD_BATCH = {fold};")
