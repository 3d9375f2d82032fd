"""compress_gpu in the no-runtime mode against the JAX package's
compress_tpu, and ops/bitpack.pack_bits_u32, on the CPU.

With BROTLI_TPU_TORCH_NO_NATIVE set (and get_lib patched to raise) the
device leg is unchanged and the host leg takes its pure-Python route;
the JAX package runs without its runtime as tests/test_native.py puts
it (_lib None, _tried True), its Pallas fold in interpret mode.  Equal
at tolerance 0 (streams byte for byte, arrays with equal dtypes):
compress_gpu at q5, q7 and q9 with the on-device inversion against
compress_tpu with BROTLI_TPU_DEVICE_INVERT=1; pack_bits_u32 against the JAX version and the numpy pack_bits,
with zero-bit and 31-bit items.  The JAX package's compress_tpu in its
default sorted-space form raises without the runtime (ROADMAP queue
3); the port's compress_gpu inverts on the device there and its stream
decodes.  Every stream decodes through libbrotlidec.  Each JAX call
compiles an interpret-mode program (3-7 s on a CPU, whatever the
size), so max_device, compress_fast, compress_mesh and
decompress_batch_gpu have tests/test_torch_no_runtime_paths.py.  Inputs: seeded phrases and an
RFC dictionary slice, 8.4 KiB in 4 KiB spans.
"""

import numpy as np
import pytest
import torch

from brotli_tpu import native_bridge as jnb
from brotli_tpu.encode import bitstream as JB
from brotli_tpu.encode.tpu_path import compress_tpu
from brotli_tpu.ops.bitpack import pack_bits_u32 as jax_pack_bits_u32
from brotli_tpu.ops.bitpack import words_u32_to_bytes as jax_words_to_bytes
from brotli_tpu_torch import compress_gpu
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.encode import bitstream as B
from brotli_tpu_torch.ops.bitpack import pack_bits_u32, words_u32_to_bytes
from .test_torch_encoder import decodes, dictionary_slice, phrases
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = (phrases(6_000, seed=91) + dictionary_slice(30_000, 32_000)
        + np.random.default_rng(92).integers(0, 256, 400, dtype=np.uint8)
        .tobytes())


def _unguarded(*args, **kwargs):
    raise AssertionError("a native binding was reached in the no-runtime "
                         "mode")


@pytest.fixture
def no_runtime(monkeypatch):
    """Both packages without their runtime; the port's get_lib raises;
    the JAX compress_tpu inverts on the device."""
    monkeypatch.setattr(jnb, "_lib", None)
    monkeypatch.setattr(jnb, "_tried", True)
    monkeypatch.setenv("BROTLI_TPU_DEVICE_INVERT", "1")
    monkeypatch.setenv(nb.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(nb, "get_lib", _unguarded)
    assert not jnb.available() and not nb.available()


def check_compress_gpu(quality: int, max_device: bool) -> bytes:
    """compress_gpu(device="cpu") equal to compress_tpu on DATA in 4 KiB
    spans, and decoded."""
    want = compress_tpu(DATA, quality=quality, span=1 << 12,
                        max_device=max_device)
    got = compress_gpu(DATA, quality=quality, span=1 << 12,
                       max_device=max_device, device="cpu")
    assert got == want
    decodes(got, DATA)
    return got


@pytest.mark.parametrize("quality", [5, 7, 9])
def test_compress_gpu_matches_compress_tpu(quality, no_runtime):
    check_compress_gpu(quality, max_device=False)


def test_compress_tpu_sorted_space_fault_and_the_port(monkeypatch,
                                                      no_runtime):
    """The reference calls its host inversion unguarded: in its default
    sorted-space form (BROTLI_TPU_DEVICE_INVERT=0, as on a fast link)
    compress_tpu raises without its runtime.  The port inverts on the
    device whatever the link, so its stream equals the device-invert
    stream and decodes."""
    monkeypatch.setenv("BROTLI_TPU_DEVICE_INVERT", "0")
    monkeypatch.setenv("BROTLI_TPU_TORCH_DEVICE_INVERT", "0")
    with pytest.raises(AttributeError, match="invert_perm32_native"):
        compress_tpu(DATA, quality=5, span=1 << 12)
    monkeypatch.setenv("BROTLI_TPU_DEVICE_INVERT", "1")
    check_compress_gpu(5, max_device=False)


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 1), (3_000, 2),
                                    (4_096, 3)])
def test_pack_bits_u32_matches_jax_and_numpy(n, seed, monkeypatch):
    """Items of 0 to 31 bits, zero-bit ones among them and last."""
    rng = np.random.default_rng(seed)
    nbits = rng.integers(0, 32, n).astype(np.int64)
    nbits[rng.random(n) < 0.1] = 0
    nbits[:2] = 31
    if n:
        nbits[-1] = 0
    bits = rng.integers(0, 1 << 31, n) & ((1 << nbits) - 1)
    total_words = int(nbits.sum()) // 32 + 2
    words, total = pack_bits_u32(torch.from_numpy(bits),
                                 torch.from_numpy(nbits), total_words)
    jw, jt = jax_pack_bits_u32(bits.astype(np.uint32),
                               nbits.astype(np.int32), total_words)
    assert words.dtype == torch.int64 and words.shape == (total_words,)
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jw).astype(np.int64))
    assert int(total) == int(jt) == int(nbits.sum())
    got = words_u32_to_bytes(words, int(total))
    want = jax_words_to_bytes(np.asarray(jw), int(jt))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    monkeypatch.setenv(nb.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(jnb, "_lib", None)
    monkeypatch.setattr(jnb, "_tried", True)
    w64, t64 = B.pack_bits(bits.astype(np.uint64), nbits)
    jw64, _ = JB.pack_bits(bits.astype(np.uint64), nbits)
    assert np.array_equal(w64, jw64) and t64 == int(total)
    assert got.tobytes() == w64.view(np.uint8).tobytes()[:(t64 + 7) // 8]


def test_pack_bits_u32_drops_words_past_the_bound():
    """Like the JAX version's mode="drop" scatter, a word past
    total_words is dropped, not an error."""
    bits = np.array([5, 7, 1], np.int64)
    nbits = np.array([31, 31, 31], np.int64)
    words, total = pack_bits_u32(torch.from_numpy(bits),
                                 torch.from_numpy(nbits), 2)
    jw, jt = jax_pack_bits_u32(bits.astype(np.uint32),
                               nbits.astype(np.int32), 2)
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jw).astype(np.int64))
    assert int(total) == int(jt) == 93
