"""compress_gpu's max_device mode, compress_fast, compress_mesh and
decompress_batch_gpu in the no-runtime mode against the JAX package's,
on the CPU.

With BROTLI_TPU_TORCH_NO_NATIVE set (and get_lib patched to raise) the
device legs (the match-rounds matcher, the fold, the decode step loop)
are unchanged and the host legs take their pure-Python routes: the
command assembly and the Python serializer after max_device's parse
committed on the device (against compress_tpu at q5 and q9); the
greedy walk, the resolve walk and the numpy bit packer after
compress_fast's matcher; the Python serializer of compress_mesh; every
header walk of decompress_batch_gpu in Python, and the Python LZ
execution with the dictionary references it resolves.  The JAX package
runs without its runtime as tests/test_native.py puts it (_lib None,
_tried True), its Pallas kernels in interpret mode.  Equal at tolerance
0: streams byte for byte, the batch decoder's outputs and n_device.
Every stream decodes through libbrotlidec.  Inputs: seeded phrases and
RFC dictionary slices of 2-12 KiB.
"""

import pytest

import brotli_tpu
from brotli_tpu import native_bridge as jnb
from brotli_tpu.decode.batch_tpu import decompress_batch_tpu
from brotli_tpu.encode.fast import compress_fast as jax_compress_fast
from brotli_tpu.parallel import mesh as JM
from brotli_tpu_torch import (compress_fast, compress_mesh,
                              decompress_batch_gpu, make_mesh)
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.decode import batch_gpu as BG
from . import oracle
from .test_torch_encoder import decodes, dictionary_slice
from .test_torch_no_runtime_device import (DATA, _unguarded,
                                           check_compress_gpu)
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def no_runtime(monkeypatch):
    """Both packages without their runtime; the port's get_lib raises."""
    monkeypatch.setattr(jnb, "_lib", None)
    monkeypatch.setattr(jnb, "_tried", True)
    monkeypatch.setenv(nb.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(nb, "get_lib", _unguarded)
    assert not jnb.available() and not nb.available()


@pytest.mark.parametrize("quality", [5, 9])
def test_compress_gpu_max_device_matches_compress_tpu(quality, no_runtime):
    check_compress_gpu(quality, max_device=True)


@pytest.mark.parametrize("quality", [0, 1])
def test_compress_fast_one_shard_matches_jax(quality, no_runtime):
    got = compress_fast(DATA, quality=quality, device="cpu")
    assert got == jax_compress_fast(DATA, quality=quality)
    decodes(got, DATA)


def test_compress_mesh_matches_jax(no_runtime):
    """Two shards at q5: store_meta_block_auto a metablock; capped
    lengths stay capped."""
    data = DATA[:8_192] + DATA[:4_000]
    want = JM.compress_mesh(data, mesh=JM.make_mesh(2), quality=5,
                            lgwin=16)
    got = compress_mesh(data, mesh=make_mesh(2, device="cpu"), quality=5,
                        lgwin=16)
    assert got == want
    decodes(got, data)


def test_decompress_batch_gpu_matches_jax(monkeypatch, no_runtime):
    """Lanes of libbrotlienc streams with dictionary references (the
    Python LZ execution resolves them) and of compress_fast and
    compress streams, every header walked in Python; a stream with
    a context-modeled metablock decodes on the host."""
    words = dictionary_slice(50_000, 53_000)
    streams = [oracle.compress(words, quality=q, lgwin=18) for q in (2, 5)]
    streams += [compress_fast(DATA[:3_000], device="cpu"),
                brotli_tpu.compress(DATA[:2_000], quality=1, lgwin=16),
                oracle.compress(DATA, quality=9, lgwin=18)]
    walks = []
    walk = BG._walk_from
    monkeypatch.setattr(BG, "_walk_from",
                        lambda *a: (walks.append(1), walk(*a))[1])
    got, n_device = decompress_batch_gpu(streams, device="cpu")
    want, want_n = decompress_batch_tpu(streams)
    assert got == want and n_device == want_n
    assert got[:2] == [words, words] and got[4] == DATA
    assert n_device >= 3 and len(walks) == len(streams)
