"""The port's compress_multi and compress_batch against brotli_tpu's,
on the CPU.

compress_multi at 1, 2, 3, 8 and 16 parts on the serial and thread
backends with favor_cpu_efficiency off and on, the process and workpool
backends, inputs under num_parts * 4096 bytes, quality 11 on the serial
and thread backends, and the first error of a failing part raised after
every part joined; compress_batch over independent payloads.  Every
case asserts equal bytes (tolerance: none) and decodes the port's
stream through the system libbrotlidec.
"""

import subprocess
import sys

import numpy as np
import pytest

import brotli_tpu
from brotli_tpu_torch import compress_batch, compress_multi
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.parallel import multi as M
from .test_torch_encoder import (ROOT, count_planner_calls, decodes,
                                 dictionary_slice, low_entropy, phrases)
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = phrases(120_000, seed=21) + dictionary_slice(0, 20_000)


def _check(data: bytes, *args, **kw) -> bytes:
    got = compress_multi(data, *args, **kw)
    assert got == brotli_tpu.compress_multi(data, *args, **kw)
    decodes(got, data)
    return got


@pytest.mark.parametrize("favor", [False, True])
@pytest.mark.parametrize("backend", ["serial", "thread"])
@pytest.mark.parametrize("parts", [1, 2, 3, 8, 16])
def test_compress_multi_matches_jax(parts, backend, favor):
    _check(DATA, parts, quality=9, backend=backend,
           favor_cpu_efficiency=favor)


@pytest.mark.parametrize("quality", [0, 2, 3, 4, 7])
def test_compress_multi_tiers_match_jax(quality):
    """The other tiers on 3 parts, with and without the shared match
    table (which serves q2-q9 and stores below q4 with the trivial
    store)."""
    a = _check(DATA, 3, quality=quality, lgwin=18)
    b = _check(DATA, 3, quality=quality, lgwin=18, backend="serial",
               favor_cpu_efficiency=True)
    assert (a == b) == (quality < 2)


def test_shared_table_low_entropy_parts_match_jax(monkeypatch):
    """Parts of one long insert: the native store refuses them for its
    buffer, and the pure-Python planner keeps them compressed, as the
    JAX package's does."""
    caps = []
    real = nb.store_metablock

    def logged(*args, cap_bits=None, **kw):
        caps.append(cap_bits)
        return real(*args, cap_bits=cap_bits, **kw)

    monkeypatch.setattr(nb, "store_metablock", logged)
    planned = count_planner_calls(monkeypatch)
    data = low_entropy(200_000)
    got = _check(data, 2, quality=5, backend="serial",
                 favor_cpu_efficiency=True)
    assert len(got) < len(data)
    assert caps == [None, None]
    assert len(planned) == 2


def test_process_backend_matches_jax():
    a = _check(DATA, 3, quality=7, backend="process")
    assert a == compress_multi(DATA, 3, quality=7, backend="serial")


@pytest.mark.parametrize("quality", [5, 9, 10])
@pytest.mark.parametrize("parts", [3, 8])
def test_workpool_backend_matches_jax(parts, quality):
    """The C API's pool, at every quality it runs (q10 included)."""
    data = DATA if quality < 10 else DATA[:40_000]
    _check(data, parts, quality=quality, backend="workpool")


@pytest.mark.parametrize("size", [0, 100, 4_095, 10_000, 60_000])
def test_input_under_parts_times_4096_matches_jax(size):
    data = DATA[:size]
    _check(data, 16, quality=9)
    _check(data, 8, quality=5, backend="workpool")


@pytest.mark.parametrize("backend", ["serial", "thread"])
def test_first_error_raised_after_all_parts_join(backend, monkeypatch):
    done = []
    real = M.compress_part

    def boom(data, i, n, params):
        if i == 2:
            raise RuntimeError("injected shard failure")
        out = real(data, i, n, params)
        done.append(i)
        return out

    monkeypatch.setattr(M, "compress_part", boom)
    with pytest.raises(RuntimeError, match="injected"):
        compress_multi(np.zeros(200_000, np.uint8).tobytes(), 4, quality=5,
                       backend=backend)
    assert sorted(done) == ([0, 1] if backend == "serial" else [0, 1, 3])


def test_optimal_parser_tiers_raise():
    """Quality 11, which raised before the optimal parser was ported:
    both backends now equal the JAX package's stream and each other."""
    data = DATA[:60_000]
    a, b = (_check(data, 3, quality=11, backend=backend)
            for backend in ("serial", "thread"))
    assert a == b


def test_host_encoder_imports_no_torch():
    """The process backend's workers import the package afresh: its
    host entry points must not pull in torch."""
    code = ("import sys, brotli_tpu_torch, brotli_tpu_torch.parallel.multi\n"
            "from brotli_tpu_torch import compress, compress_batch\n"
            "print('torch' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"


@pytest.mark.parametrize("threads", [1, 3])
def test_compress_batch_matches_jax(threads):
    rng = np.random.default_rng(4)
    payloads = [DATA[:50_000], rng.integers(0, 256, 30_000,
                                            dtype=np.uint8).tobytes(),
                b"", b"x" * 100_000]
    got = compress_batch(payloads, threads=threads, quality=9)
    assert got == brotli_tpu.compress_batch(payloads, threads=threads,
                                            quality=9)
    for out, data in zip(got, payloads):
        decodes(out, data)
    with pytest.raises(TypeError):
        compress_batch([DATA, object()], threads=threads, quality=9)
