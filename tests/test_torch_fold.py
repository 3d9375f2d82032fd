"""brotli_tpu_torch's fold against brotli_tpu's Pallas fold.

The plain PyTorch fold (what the CUDA kernel is held to on the card)
and the tier wrappers run on CPU tensors; the JAX side runs the Pallas
kernel in interpret mode.  Inputs come from a numpy seed: repeated
phrases (matches at many distances) mixed with random bytes, so key
words with the top bit set are common and the signed int32 key order
differs from the unsigned one.  Tolerance: exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brotli_tpu.ops import fold_pallas as FP
from brotli_tpu.ops.matching import u32_values_at as jax_u32_at
from brotli_tpu_torch.ops import fold_cuda as FC
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 20000           # not a multiple of the Pallas tile (16384)
WINDOW = 1 << 14


def _data(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    phrases = [rng.integers(0, 256, size=int(rng.integers(3, 48)),
                            dtype=np.uint8) for _ in range(96)]
    out, total = [], 0
    while total < n:
        if rng.random() < 0.2:
            piece = rng.integers(0, 256, size=int(rng.integers(1, 24)),
                                 dtype=np.uint8)
        else:
            piece = phrases[int(rng.integers(0, len(phrases)))].copy()
            if rng.random() < 0.3:  # near-repeats: one byte changed
                piece[int(rng.integers(0, len(piece)))] ^= 0x80
        out.append(piece)
        total += len(piece)
    return np.concatenate(out)[:n]


def _sorted_ops(d: np.ndarray, n_keys: int, n_pay: int):
    """Sorted operands built the way the JAX wrappers build them."""
    x = jnp.asarray(d)
    pos = jnp.arange(len(d), dtype=jnp.int32)
    if n_keys == 1:
        v = [jax_u32_at(x, 4 * r) for r in range(n_pay + 1)]
        ops = jax.lax.sort((v[0].astype(jnp.int32), pos) + tuple(v[1:]),
                           num_keys=1, is_stable=True)
    else:
        v = [jax_u32_at(x, 4 * r) for r in range(n_pay + 2)]
        ops = jax.lax.sort((v[0], v[1], pos) + tuple(v[2:]),
                           num_keys=2, is_stable=True)
    return [np.asarray(o) for o in ops]


# (n_keys, n_pay, k_fwd, k_back, fuse_short): the four configurations
# of the compress path, exact9_fused's fused short fold, the two
# max_device folds (6 attested rounds: 5 payloads) and a 4-payload one
CONFIGS = {
    "q2-6": (1, 1, 32, 0, False),
    "q7-8": (2, 0, 16, 8, False),
    "q9-main": (2, 2, 16, 8, False),
    "q9-short": (1, 1, 16, 0, False),
    "fused": (2, 2, 16, 8, True),
    "p4": (1, 4, 32, 0, False),
    "max-device-q2-6": (1, 5, 32, 0, False),
    "max-device-q7-9": (1, 5, 16, 0, False),
}


@pytest.mark.parametrize("case", ["base", "min_pos", "small_window"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_fold_ref_matches_pallas(config, case):
    n_keys, n_pay, k_fwd, k_back, fuse = CONFIGS[config]
    d = _data(N, seed=7)
    ops = _sorted_ops(d, n_keys, n_pay)
    assert (ops[0].view(np.uint32) >= 1 << 31).any()
    min_pos = 4321 if case == "min_pos" else 0
    window = 300 if case == "small_window" else WINDOW
    kw = dict(n_keys=n_keys, k_fwd=k_fwd, k_back=k_back, window=window,
              lbs=135, len_shift=26, n_real=N, fuse_short=fuse)
    jp, js = FP.fold_sorted_pallas(tuple(jnp.asarray(o) for o in ops),
                                   min_pos, interpret=True, **kw)
    tp, ts = FC.fold_sorted([torch.from_numpy(o.view(np.int32).copy())
                             for o in ops], min_pos, **kw)
    assert tp.dtype == ts.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    hits = (tp.numpy() != 0).sum()
    assert hits > (0 if case == "small_window" else N // 10)


def _wrapper_pair(name):
    return {
        "exact": (FP.best_matches_exact_p, FC.best_matches_exact_p,
                  dict(k=32, rounds=2)),
        "exact_r6": (FP.best_matches_exact_p, FC.best_matches_exact_p,
                     dict(k=16, rounds=6)),
        "exact8": (FP.best_matches_exact8_p, FC.best_matches_exact8_p,
                   dict(k=16, rounds=2)),
        "exact8_r4": (FP.best_matches_exact8_p, FC.best_matches_exact8_p,
                      dict(k=16, rounds=4)),
        "exact9": (FP.best_matches_exact9_p, FC.best_matches_exact9_p,
                   dict(k=16, k_short=16, rounds=4)),
        "exact9_fused": (FP.best_matches_exact9_fused,
                         FC.best_matches_exact9_fused,
                         dict(k=16, rounds=4)),
    }[name]


@pytest.mark.parametrize("invert", [True, False])
@pytest.mark.parametrize("name", ["exact", "exact_r6", "exact8",
                                  "exact8_r4", "exact9", "exact9_fused"])
def test_wrapper_matches_pallas(name, invert):
    jfn, tfn, kw = _wrapper_pair(name)
    d = _data(N, seed=11)
    min_pos = 1000 if invert else 0
    jout = jfn(jnp.asarray(d), WINDOW, min_pos=min_pos, invert=invert,
               interpret=True, **kw)
    tout = tfn(torch.from_numpy(d), WINDOW, min_pos=min_pos,
               invert=invert, **kw)
    if not isinstance(jout, tuple):
        jout, tout = (jout,), (tout,)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_u32_values_match_jax():
    d = _data(4099, seed=3)
    for off in (0, 4, 8, 12):
        t = FC.u32_values_at(torch.from_numpy(d), off)
        j = np.asarray(jax_u32_at(jnp.asarray(d), off))
        np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))
        np.testing.assert_array_equal(
            FC.as_i32(t).numpy(), j.view(np.int32))


def test_fold_counts_no_launch_on_cpu():
    """The CPU path runs the plain version and launches nothing."""
    d = _data(2048, seed=5)
    before = dict(FC.LAUNCHES)
    FC.best_matches_exact9_p(torch.from_numpy(d), WINDOW, invert=False)
    assert FC.LAUNCHES == before
