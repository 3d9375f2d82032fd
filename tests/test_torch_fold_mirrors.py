"""brotli_tpu_torch's fold mirrors against brotli_tpu's.

The seven plain tensor-op forms of the fold in ops/matching.py
(_fold_sorted_packed, best_matches_packed, _fold_fused,
best_matches_fused, best_matches_exact, best_matches_exact8,
best_matches_exact9) run on CPU tensors against the JAX package's
functions of the same names; best_matches_exact / 8 / 9 also against
brotli_tpu.ops.fold_pallas's tier wrappers (the Pallas fold in
interpret mode) and against the port's own tier wrappers in
ops/fold_cuda.py (their plain version on the CPU).  Inputs come from a
numpy seed: repeated phrases of random bytes (key words with the top
bit set are common, so the signed int32 key order differs from the
unsigned one), a run of zero bytes (its keys sort first, next to the
pads of the sorted arrays) and a slice of the RFC 7932 dictionary.  Tolerance:
exact equality of every packed word and score.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brotli_tpu.ops import fold_pallas as FP
from brotli_tpu.ops import matching as JM
from brotli_tpu_torch.ops import fold_cuda as FC
from brotli_tpu_torch.ops import matching as TM
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WINDOW = 1 << 14
MIN_POS = 3000
DICT = "brotli_tpu_torch/data/dictionary.bin"


def _data(n_phrases: int, seed: int, dict_bytes: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    phrases = [rng.integers(0, 256, size=int(rng.integers(3, 40)),
                            dtype=np.uint8) for _ in range(60)]
    pick = rng.integers(0, len(phrases), size=n_phrases // 8)
    text = np.concatenate([phrases[i] for i in pick])[:n_phrases]
    # a run of zero bytes: keys 0 and h4 0 sort first, beside the pads
    text[n_phrases // 3:n_phrases // 3 + 40] = 0
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dic = np.fromfile(os.path.join(root, DICT), np.uint8)
    return np.concatenate([text, dic[20000:20000 + dict_bytes]])


# 12 KiB (8 KiB of phrases, 4 KiB of the dictionary) and 2 KiB
DATA = {"12k": (8192, 3, 4096), "2k": (1536, 11, 512)}


@pytest.fixture(scope="module")
def inputs():
    return {k: _data(*v) for k, v in DATA.items()}


def _equal(want, got):
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w).astype(np.int64)
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        assert np.array_equal(w, g.numpy().astype(np.int64))
    assert np.count_nonzero(np.asarray(want[0])) > 0   # some matches


def test_inputs_have_negative_keys(inputs):
    """The int32 keys go negative, so signed and unsigned orders differ."""
    for d in inputs.values():
        v0 = TM.as_i32(TM.u32_values(torch.from_numpy(d.copy())))
        assert (v0 < 0).sum() > len(d) // 10
        assert not torch.equal(torch.argsort(v0, stable=True),
                               torch.argsort(v0.long() & 0xFFFFFFFF,
                                             stable=True))


# (function, data, keyword arguments): min_pos 0 and > 0, k8 0 and > 0,
# len_shift 26 and another, the tier settings of gpu_path._device_knobs
PUBLIC = [
    ("packed", "12k", dict(k=8, k8=4, rounds=4)),
    ("packed", "12k", dict(k=8, k8=0, rounds=2, min_pos=MIN_POS)),
    ("fused", "12k", dict(k=8, k8=4, rounds=4)),
    ("fused", "12k", dict(k=16, k8=0, rounds=2, min_pos=MIN_POS,
                          len_shift=20)),
    ("fused", "2k", dict(k=16, k8=8, rounds=4)),
    ("exact", "12k", dict(k=32, k8=0, rounds=2)),
    ("exact", "12k", dict(k=8, k8=8, rounds=4, min_pos=MIN_POS)),
    ("exact8", "12k", dict(k=16, rounds=2)),
    ("exact8", "12k", dict(k=8, rounds=4, min_pos=MIN_POS,
                           _with_score=True)),
    ("exact8", "12k", dict(k=16, rounds=3, len_shift=24)),
    ("exact9", "12k", dict(k=16, k_short=16, rounds=4)),
    ("exact9", "12k", dict(k=8, k_short=8, rounds=2, min_pos=MIN_POS)),
]


@pytest.mark.parametrize("name,size,kw", PUBLIC,
                         ids=[f"{n}-{s}-{i}" for i, (n, s, _) in
                              enumerate(PUBLIC)])
def test_mirror_matches_jax(inputs, name, size, kw):
    d = inputs[size]
    want = getattr(JM, "best_matches_" + name)(jnp.asarray(d), WINDOW,
                                                **kw)
    got = getattr(TM, "best_matches_" + name)(torch.from_numpy(d.copy()),
                                               WINDOW, **kw)
    _equal(want, got)


def _operands(d: np.ndarray, rounds: int):
    """Both packages' u32 chunk values (offsets 0, 4, ...) of d."""
    x, t = jnp.asarray(d), torch.from_numpy(d.copy())
    return ([JM.u32_values_at(x, 4 * r) for r in range(rounds)],
            [TM.u32_values_at(t, 4 * r) for r in range(rounds)])


def _prior(n: int, seed: int, high: int):
    """A running best from an earlier fold: random words, some zero."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, high, size=n, dtype=np.int32)
    return np.where(rng.random(n) < 0.5, 0, x).astype(np.int32)


@pytest.mark.parametrize("min_pos", [0, MIN_POS])
def test_fold_sorted_packed_matches_jax(inputs, min_pos):
    """The hashed h8 fold (k = 8) merged into a prior running best."""
    d = inputs["12k"]
    jv, tv = _operands(d, 3)
    jh = ((jv[0] * JM.HASH_MUL32) ^ (jv[1] * JM.HASH_MUL32B)) \
        >> np.uint32(32 - 18)
    th = (TM.mul32(tv[0], TM.HASH_MUL32)
          ^ TM.mul32(tv[1], TM.HASH_MUL32B)) >> (32 - 18)
    best = (_prior(len(d), 1, 135 * 12 << 6), _prior(len(d), 2, WINDOW))
    want = JM._fold_sorted_packed(jh, 8, jv, WINDOW, 135,
                                  tuple(jnp.asarray(b) for b in best),
                                  min_pos)
    got = TM._fold_sorted_packed(th, 8, tv, WINDOW, 135,
                                 tuple(torch.from_numpy(b) for b in best),
                                 min_pos)
    _equal(want, got)


# (key, base_len, require_full, a prior best, min_pos, len_shift)
FUSED = {
    "hash-full": ("h8", 0, True, False, 0, 26),
    "hash-full-min-pos": ("h8", 0, True, True, MIN_POS, 26),
    "content-merge": ("v0", 4, False, True, MIN_POS, 20),
    "content-full": ("v0", 4, True, False, 0, 26),
}


@pytest.mark.parametrize("case", list(FUSED))
def test_fold_fused_matches_jax(inputs, case):
    key, base_len, full, prior, min_pos, len_shift = FUSED[case]
    d = inputs["12k"]
    jv, tv = _operands(d, 3)
    if key == "h8":
        jh = ((jv[0] * JM.HASH_MUL32) ^ (jv[1] * JM.HASH_MUL32B)) \
            .astype(jnp.int32)
        th = TM.as_i32(TM.mul32(tv[0], TM.HASH_MUL32)
                       ^ TM.mul32(tv[1], TM.HASH_MUL32B))
        jvs, tvs = jv, tv
    else:
        jh, th = jv[0].astype(jnp.int32), TM.as_i32(tv[0])
        jvs, tvs = jv[1:], tv[1:]
    best = None
    if prior:
        best = (_prior(len(d), 3, 12 << len_shift),
                _prior(len(d), 4, 135 * 12))
    want = JM._fold_fused(
        jh, 12, jvs, WINDOW, 135,
        None if best is None else tuple(jnp.asarray(b) for b in best),
        min_pos, len_shift, base_len=base_len, require_full=full)
    got = TM._fold_fused(
        th, 12, tvs, WINDOW, 135,
        None if best is None else tuple(torch.from_numpy(b) for b in best),
        min_pos, len_shift, base_len=base_len, require_full=full)
    _equal(want, got)


# the three tier matchers at gpu_path._device_knobs' settings (the exact
# fold at k = 16, exact8 at q9's rounds, so that exact9 reuses both
# interpret-mode programs), min_pos > 0 on one
TIERS = [
    ("exact", dict(k=16, rounds=2, min_pos=MIN_POS)),
    ("exact8", dict(k=16, rounds=4)),
    ("exact9", dict(k=16, k_short=16, rounds=4)),
]


@pytest.mark.parametrize("name,kw", TIERS, ids=[t[0] for t in TIERS])
def test_mirror_matches_pallas_tier_wrapper(inputs, name, kw):
    """Each tier mirror equals the JAX package's Pallas tier wrapper
    (interpret mode), as the JAX package's own tests hold them."""
    d = inputs["12k"]
    want = getattr(FP, f"best_matches_{name}_p")(jnp.asarray(d), WINDOW,
                                                 interpret=True, **kw)
    got = getattr(TM, "best_matches_" + name)(torch.from_numpy(d.copy()),
                                               WINDOW, **kw)
    _equal(want, got)


@pytest.mark.parametrize("min_pos", [0, MIN_POS])
@pytest.mark.parametrize("name,kw", TIERS, ids=[t[0] for t in TIERS])
def test_mirror_matches_port_tier_wrapper(inputs, name, kw, min_pos):
    """Each tier mirror equals the port's tier wrapper (fold_cuda; on
    CPU tensors its plain version fold_sorted_ref), which chip_smoke.py
    and tests/test_torch_cuda.py hold it to on the card."""
    kw = dict(kw, min_pos=min_pos)
    t = torch.from_numpy(inputs["12k"].copy())
    want = getattr(FC, f"best_matches_{name}_p")(t, WINDOW, **kw)
    got = getattr(TM, "best_matches_" + name)(t, WINDOW, **kw)
    _equal(want.numpy(), got)


def test_packing_overflow_raises():
    t = torch.zeros(64, dtype=torch.uint8)
    for fn in (TM.best_matches_fused, TM.best_matches_exact,
               TM.best_matches_exact8):
        with pytest.raises(ValueError, match="int32 packing"):
            fn(t, WINDOW, rounds=8, len_shift=27)


def test_fold_bench_runs_on_cpu(inputs):
    """research/fold_bench.run on the host: every case, each tier
    mirror equal to its tier wrapper, no time taken without a card."""
    from brotli_tpu_torch.research import fold_bench
    res = fold_bench.run("cpu", torch.from_numpy(inputs["12k"].copy()),
                         log=lambda *a: None)
    assert [(r["setting"], r["mirror"]) for r in res] == [
        (c[0], "best_matches_" + c[1]) for c in fold_bench.cases()]
    assert {r["setting"] for r in res} == {
        "q5", "q7", "q9", "max_device q5", "max_device q9"}
    assert sum(r["wrapper"] is not None for r in res) == 11
    assert all(r["mirror_ms"] is None and r["matches"] > 0 for r in res)
