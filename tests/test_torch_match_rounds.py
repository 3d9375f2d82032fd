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
