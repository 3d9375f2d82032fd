"""committed_parse and compress_gpu(max_device=True) against brotli_tpu.

The device parse commitment (pointer doubling over sub-blocks) on
seeded lengths and scores, and the max_device stream byte for byte
against compress_tpu(max_device=True), whose fold runs in Pallas
interpret mode.  Streams decode through brotli_tpu's decoder and the
system libbrotlidec.  Tolerance: exact equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from . import oracle
from brotli_tpu import decompress
from brotli_tpu.encode.tpu_path import compress_tpu
from brotli_tpu.ops.parse import committed_parse as jparse
from brotli_tpu_torch import compress_gpu
from brotli_tpu_torch.ops import fold_cuda as FC
from brotli_tpu_torch.ops.parse import committed_parse
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("sub_block", [64, 4096])
def test_committed_parse_matches_jax(sub_block):
    rng = np.random.default_rng(sub_block)
    n = 4 * 4096
    best_len = np.where(rng.random(n) < 0.4, rng.integers(2, 300, n),
                        rng.integers(0, 4, n)).astype(np.int32)
    best_score = np.where(best_len >= 4, rng.integers(0, 2000, n),
                          rng.integers(0, 150, n)).astype(np.int32)
    jv, jt = jparse(jnp.asarray(best_len), jnp.asarray(best_score),
                    sub_block)
    tv, tt = committed_parse(torch.from_numpy(best_len),
                             torch.from_numpy(best_score), sub_block)
    assert tv.dtype == torch.bool and tt.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the walk takes copies and literals, and every sub-block starts
    visited = tv.numpy()
    assert visited[::sub_block].all()
    assert 0 < visited.sum() < n
    with pytest.raises(ValueError):
        committed_parse(torch.from_numpy(best_len[:-1]),
                        torch.from_numpy(best_score[:-1]), sub_block)


def _corpus(seed: int = 3) -> bytes:
    """Zipf words, records with noise and random bytes: two spans of
    64 KiB, the second short."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, size=int(rng.integers(2, 9)),
                                dtype=np.uint8)) for _ in range(300)]
    text = b" ".join(words[int(i)] for i in
                     rng.zipf(1.3, size=20000) % len(words))[:50000]
    rec = np.tile(rng.integers(0, 256, 48, dtype=np.uint8), 400)
    rec[rng.integers(0, len(rec), 1500)] = 7
    return (text + rec.tobytes()
            + rng.integers(0, 256, 1000, dtype=np.uint8).tobytes())


DATA = _corpus()


@pytest.mark.parametrize("quality", [2, 5, 7, 9])
def test_max_device_matches_compress_tpu(quality):
    want = compress_tpu(DATA, quality=quality, span=1 << 16,
                        max_device=True)
    before = dict(FC.LAUNCHES)
    got = compress_gpu(DATA, quality=quality, span=1 << 16,
                       max_device=True, device="cpu")
    assert FC.LAUNCHES == before
    assert got == want
    assert decompress(got) == DATA
    if oracle.available():
        assert oracle.decompress(got) == DATA
