"""compress_gpu(device="cpu") against brotli_tpu's compress_tpu.

Both run the q2-q9 device path on about 60 KiB in 16 KiB spans (four
dispatches, so the in-flight pipeline and the distance cache carry
across spans); the JAX side runs its Pallas fold in interpret mode.
The streams must be byte-identical and decode through brotli_tpu's
decoder and the system libbrotlidec; also on 48,000 bytes of the
repo's docs, where the static dictionary takes many positions.
"""

import os

import numpy as np
import pytest

from . import oracle
from brotli_tpu import decompress
from brotli_tpu.encode.tpu_path import compress_tpu
from brotli_tpu_torch import compress_gpu
from brotli_tpu_torch.encode import gpu_path as G
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _corpus(seed: int = 1) -> bytes:
    """Zipf words, records with noise and a few random bytes."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, size=int(rng.integers(2, 9)),
                                dtype=np.uint8)) for _ in range(300)]
    text = b" ".join(words[int(i)] for i in
                     rng.zipf(1.3, size=20000) % len(words))[:40000]
    rec = np.tile(rng.integers(0, 256, 48, dtype=np.uint8), 500)
    rec[rng.integers(0, len(rec), 2000)] = 7
    return (text + rec.tobytes()[:20000]
            + rng.integers(0, 256, 1500, dtype=np.uint8).tobytes())


DATA = _corpus()


@pytest.mark.parametrize("quality", range(2, 10))
def test_compress_gpu_cpu_matches_compress_tpu(quality):
    want = compress_tpu(DATA, quality=quality, span=1 << 14)
    stats = {}
    got = compress_gpu(DATA, quality=quality, span=1 << 14, stats=stats,
                       device="cpu")
    assert got == want
    assert decompress(got) == DATA
    if oracle.available():
        assert oracle.decompress(got) == DATA
    assert set(stats) == {"wall_s", "device_wait_s", "spans",
                          *G.DICT_COUNTERS, *G.PARSE_COUNTERS,
                          *G.MATCH_COUNTERS}
    assert 0.0 <= stats["device_wait_s"] <= stats["wall_s"]
    assert [s[0] for s in stats["spans"]].count("host_parse") == 4


def _docs(n: int) -> bytes:
    """The first n bytes of the repo's English docs: text where the
    static dictionary takes many positions."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return b"".join(open(os.path.join(root, name), "rb").read()
                    for name in ("SURVEY.md", "README.md"))[:n]


@pytest.mark.parametrize("quality", [5, 7, 9])
def test_compress_gpu_cpu_matches_compress_tpu_on_text(quality):
    """On dictionary-dense text the card's dictionary candidates, here
    the plain version's, and their merge give compress_tpu's stream."""
    data = _docs(48_000)
    stats = {}
    got = compress_gpu(data, quality=quality, span=1 << 14, stats=stats,
                       device="cpu")
    assert stats["dict.won"] > len(data) // 100
    assert got == compress_tpu(data, quality=quality, span=1 << 14)
    assert decompress(got) == data


@pytest.mark.parametrize("data", [b"", b"a", b"abcabcabcabcabcabcabc" * 3])
def test_compress_gpu_tiny_inputs(data):
    got = compress_gpu(data, quality=9, device="cpu")
    assert got == compress_tpu(data, quality=9)
    assert decompress(got) == data


@pytest.mark.parametrize("quality", [5, 7, 9])
def test_compress_gpu_device_invert_same_stream(quality, monkeypatch):
    """The on-device inversion form gives the sorted-space form's
    stream."""
    monkeypatch.setenv("BROTLI_TPU_TORCH_DEVICE_INVERT", "0")
    want = compress_gpu(DATA, quality=quality, span=1 << 14, device="cpu")
    monkeypatch.setenv("BROTLI_TPU_TORCH_DEVICE_INVERT", "1")
    got = compress_gpu(DATA, quality=quality, span=1 << 14, device="cpu")
    assert got == want
