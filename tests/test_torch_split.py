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
