"""The port's hashed transform index of the static dictionary
(static_dict.expanded_dict_index) and the runtime's collector over it
(native_bridge.collect_dict) against brotli_tpu's, on the CPU; and the
numpy builder of the sorted index (static_dict.sorted_dict_index where
the runtime is not in use), which sorts that index, against the
runtime's and the JAX package's numpy builder.

The index is built in Python from every (word x transform) output, a
few seconds in each package, so it has a file of its own.  Tolerance:
none (equal arrays).
"""

import numpy as np
import pytest

from brotli_tpu import native_bridge as jnb
from brotli_tpu.encode import static_dict as JS
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.encode import static_dict as S
from .test_torch_encoder import dictionary_slice, phrases
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def indexes():
    return S.expanded_dict_index(), JS.expanded_dict_index()


def test_expanded_dict_index_matches_jax(indexes):
    got, want = indexes
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    entry_bytes, out_len, wire, wid, table = got
    assert entry_bytes.shape == (len(out_len), S.EXT_MAX_OUT)
    assert table.shape == (1 << S.EXT_HASH_BITS, S.EXT_SLOTS)
    # every output the sorted index holds is an output of this one
    assert len(S.sorted_dict_index()[1]) <= len(out_len)


@pytest.mark.parametrize("dict_len", [0, 3_000])
@pytest.mark.parametrize("window", [(1 << 10) - 16, (1 << 22) - 16])
def test_collect_dict_matches_jax(indexes, window, dict_len):
    data = np.frombuffer(phrases(20_000, seed=41)
                         + dictionary_slice(10_000, 30_000), np.uint8)
    (eb, eo, ew, ewid, table), _ = indexes
    got = nb.collect_dict(data, dict_len, window, eb, eo, ew, ewid, table,
                          S.EXT_HASH_BITS)
    want = jnb.collect_dict(data, dict_len, window, eb, eo, ew, ewid,
                            table, JS.EXT_HASH_BITS)
    assert len(got) == 4 and len(got[0]) > 1000
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_sorted_dict_index_numpy_matches_native_and_jax(indexes,
                                                        monkeypatch):
    native = nb.sorted_dict_index_native()
    monkeypatch.setenv(nb.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(jnb, "_lib", None)
    monkeypatch.setattr(jnb, "_tried", True)
    got = S.sorted_dict_index.__wrapped__()
    want = JS.sorted_dict_index.__wrapped__()
    assert len(got) == len(native) == len(want) == 4
    for a, b, c in zip(got, native, want):
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)
