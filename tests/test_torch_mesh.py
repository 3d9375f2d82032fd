"""The port's multi-shard path, merge, entry points and profiling helpers
against the JAX package, on the CPU.

compress_mesh(device="cpu") must equal brotli_tpu.parallel.mesh.
compress_mesh over make_mesh(n) of the conftest's virtual CPU devices
byte for byte (the JAX side runs its Pallas folds in interpret mode),
on small inputs (the host encoder) and on blocks the native store
refuses too, decode through the system libbrotlidec, and stay within 1%
of the port's compress_multi (equal to brotli_tpu's) at the same shard
count; sharded_pipeline
and match_pipeline must give the JAX pipelines' arrays; the port's
BroCatli must merge and refuse as the JAX one does; entry()'s step must
give the JAX step's arrays.  Inputs: a repeated phrase with seeded
noise, as __graft_entry__.dryrun_multichip makes them.  Tolerance:
exact equality throughout.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from . import oracle
import brotli_tpu
from brotli_tpu import native_bridge as jnb
from brotli_tpu.concat.brocatli import BroCatli as JaxBroCatli
from brotli_tpu.parallel import mesh as JM
from brotli_tpu.parallel import multi as JMULTI
from brotli_tpu.encode.params import EncoderParams as JaxParams
from brotli_tpu_torch import compress_mesh, compress_multi, make_mesh
from brotli_tpu_torch import entry as E
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.concat.brocatli import BroCatli, BroCatliResult
from brotli_tpu_torch.parallel import mesh as M
from brotli_tpu_torch.parallel.multi import _get_range, _merge
from brotli_tpu_torch.utils.profiling import (KernelStats, device_trace,
                                              measure_kernel)
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _phrases(n: int, seed: int = 1, noise: float = 0.15) -> bytes:
    rng = np.random.default_rng(seed)
    text = b"the quick brown fox jumps over the lazy dog. " * (n // 45 + 1)
    mask = rng.random(len(text)) < noise
    raw = np.where(mask, rng.integers(0, 256, len(text), dtype=np.uint8),
                   np.frombuffer(text, np.uint8)).astype(np.uint8)
    return raw.tobytes()[:n]


def _decodes(out: bytes, data: bytes) -> None:
    assert nb.decode(out) == data
    if oracle.available():
        assert oracle.decompress(out, max_size_hint=len(data)) == data


def _random_middle(n: int) -> bytes:
    """_phrases(n) with 160,000 seeded random bytes from n / 4 on: at
    lgblock 16 the native store refuses the random metablocks (their
    long inserts)."""
    rng = np.random.default_rng(9)
    at = n // 4
    return (_phrases(n)[:at] + rng.integers(0, 256, 160_000, dtype=np.uint8)
            .tobytes() + _phrases(n)[at + 160_000:])


# (quality, shards, lgblock, bytes): q9 on one and on eight shards, q5
# (the 3-payload fold) on four, and q9 on four shards of 160 KiB in
# metablocks of 64 KiB, with a random middle whose metablocks the native
# store refuses (stored uncompressed, as the JAX package's pure-Python
# store leaves them)
MESH_CASES = [(9, 1, 0, 184_320), (9, 8, 0, 184_320), (5, 4, 0, 184_320),
              (9, 4, 16, 640 << 10)]


@pytest.mark.parametrize("quality,shards,lgblock,size", MESH_CASES)
def test_compress_mesh_matches_jax(quality, shards, lgblock, size):
    data = _random_middle(size) if lgblock else _phrases(size)
    want = JM.compress_mesh(data, mesh=JM.make_mesh(shards),
                            quality=quality, lgwin=16, lgblock=lgblock)
    stats = {}
    got = compress_mesh(data, mesh=make_mesh(shards, device="cpu"),
                        quality=quality, lgwin=16, lgblock=lgblock,
                        stats=stats)
    assert got == want
    _decodes(got, data)
    assert set(stats) == {"wall_s", "device_wait_s", "device_fraction"}


def test_dryrun_multichip_within_one_percent_of_compress_multi():
    out = E.dryrun_multichip(8, device="cpu")
    data = E.dryrun_data()
    _decodes(out, data)
    ref = compress_multi(data, 8, quality=9, lgwin=16, backend="serial")
    assert ref == JMULTI.compress_multi(data, 8, quality=9, lgwin=16,
                                        backend="serial")
    assert len(out) <= len(ref) * 1.01


@pytest.mark.parametrize("size", [0, 1, 5_000, 8 * 4096 - 1])
def test_compress_mesh_small_input_matches_jax(size):
    """Under 4096 bytes a shard the input goes to the host encoder."""
    data = _phrases(size)
    want = JM.compress_mesh(data, mesh=JM.make_mesh(8), quality=5,
                            lgwin=16, lgblock=16)
    got = compress_mesh(data, n_shards=8, quality=5, lgwin=16, lgblock=16,
                        device="cpu")
    assert got == want == brotli_tpu.compress(data, quality=5, lgwin=16)
    _decodes(got, data)


def test_refused_block_below_q4_matches_jax(monkeypatch):
    """Below quality 4, a block that both packages' native store refuses
    is stored with the trivial store and kept under 8 * mlen + 40 bits,
    as the JAX package keeps it."""
    data = _phrases(60_000)
    outs = []
    for mod, fn, mesh in ((jnb, JM.compress_mesh, JM.make_mesh(2)),
                          (nb, compress_mesh, make_mesh(2, device="cpu"))):
        monkeypatch.setattr(mod, "encode_metablock", lambda *a, **k: None)
        outs.append(fn(data, mesh=mesh, quality=2, lgwin=16))
    assert outs[1] == outs[0]
    assert len(outs[1]) < len(data) // 2
    _decodes(outs[1], data)


def test_compress_mesh_keeps_refused_low_entropy_blocks_like_jax(monkeypatch):
    """Seeded bytes of 180 symbols (about 7.5 bits a byte, almost no
    match): at lgblock 16 the native store refuses every full metablock
    for its long insert, and the JAX package's pure-Python store keeps
    it compressed.  At quality >= 4 the port's store_meta_block_auto
    plans such a block with its own pure-Python planner, and the bytes
    must equal the JAX package's."""
    calls = []
    real = nb.encode_metablock

    def logged(*a, cap_bits=None, **k):
        res = real(*a, cap_bits=cap_bits, **k)
        calls.append((cap_bits, res is None))
        return res

    data = np.random.default_rng(5).integers(0, 180, 400_000,
                                             dtype=np.uint8).tobytes()
    want = JM.compress_mesh(data, mesh=JM.make_mesh(4), quality=5,
                            lgwin=16, lgblock=16)
    monkeypatch.setattr(nb, "encode_metablock", logged)
    got = compress_mesh(data, mesh=make_mesh(4, device="cpu"), quality=5,
                        lgwin=16, lgblock=16)
    assert got == want
    assert len(got) < len(data)
    assert sum(1 for cap, refused in calls if cap is None and refused) >= 4
    _decodes(got, data)


def test_make_mesh_places_shards():
    assert make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


def test_make_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(8)


def test_shard_input_matches_jax():
    raw = np.frombuffer(_phrases(20_001), np.uint8)
    np.testing.assert_array_equal(M.shard_input(raw, 3),
                                  JM.shard_input(raw, 3))


def test_sharded_and_match_pipelines_match_jax():
    blocks = np.frombuffer(_phrases(2 * 8192, seed=2, noise=0.3),
                           np.uint8).reshape(2, 8192)
    window = (1 << 16) - 16
    jmesh, tmesh = JM.make_mesh(2), make_mesh(2, device="cpu")
    want = JM.sharded_pipeline(jmesh, window)(jnp.asarray(blocks))
    got = M.sharded_pipeline(tmesh, window)(blocks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) > 0
    want = JM.match_pipeline(jmesh, window)(jnp.asarray(blocks))
    got = M.match_pipeline(tmesh, window)(blocks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[4]) == int(got[3].sum()) > 0


def test_compact_drops_past_capacity():
    keep = torch.tensor([1, 0, 1, 1, 0, 1, 1], dtype=torch.bool)
    vals = torch.arange(7, dtype=torch.int32) * 10
    out, count = M._compact(keep, 3, vals)
    assert out.tolist() == [0, 20, 30] and int(count) == 3
    out, count = M._compact(keep, 8, vals)
    assert out.tolist() == [0, 20, 30, 50, 60, 0, 0, 0] and int(count) == 5


# ---------------------------------------------------------------------------
# BroCatli and the merge
# ---------------------------------------------------------------------------


def _pieces(data: bytes, n: int, lgwin: int = 18) -> list:
    """The JAX package's CompressMulti pieces: part 0 appendable, the
    rest catable with the prefix as their dictionary."""
    raw = np.frombuffer(data, np.uint8)
    params = JaxParams(quality=5, lgwin=lgwin).sanitize(None)
    return [JMULTI.compress_part(raw, i, n, params) for i in range(n)]


def test_get_range_matches_jax():
    for n in (0, 1, 7, 100_003):
        for parts in (1, 3, 16):
            assert [_get_range(i, parts, n) for i in range(parts)] == \
                [JMULTI._get_range(i, parts, n) for i in range(parts)]


def test_brocatli_merges_like_jax():
    data = _phrases(60_000, seed=3)
    pieces = _pieces(data, 3)
    got = _merge(pieces)
    assert got == JMULTI._merge(pieces)
    _decodes(got, data)
    # fed in 7-byte chunks the merge asks for more input, and gives the
    # same stream
    bc, out = BroCatli(), bytearray()
    for piece in pieces:
        bc.new_brotli_file()
        for at in range(0, len(piece), 7):
            assert bc.stream(piece[at:at + 7], out) in (
                BroCatliResult.NeedsMoreInput, BroCatliResult.Success)
    assert bc.finish(out) == BroCatliResult.Success
    assert bytes(out) == got


def test_brocatli_refusals_match_jax():
    plain = oracle.compress(b"hello world " * 500, quality=5, lgwin=18) \
        if oracle.available() else None
    catable = _pieces(_phrases(20_000, seed=4), 2, lgwin=18)
    wide = _pieces(_phrases(20_000, seed=5), 2, lgwin=22)
    cases = [[catable[0], wide[1]]]
    if plain is not None:
        cases.append([plain, catable[1]])
    for streams in cases:
        results = []
        for cls in (BroCatli, JaxBroCatli):
            bc, out, res = cls(), bytearray(), []
            for s in streams:
                bc.new_brotli_file()
                res.append(int(bc.stream(s, out)))
            res.append(int(bc.finish(out)))
            results.append((res, bytes(out)))
        assert results[0] == results[1]
    # the window refusal and the plain-file refusal, by name
    with pytest.raises(ValueError, match="WindowSizeLargerThanPreviousFile"):
        _merge(cases[0])
    if plain is not None:
        with pytest.raises(ValueError, match="NotCraftedForAppend"):
            _merge(cases[1])


def test_brocatli_state_round_trip_matches_jax():
    pieces = _pieces(_phrases(40_000, seed=6), 2)
    bc, out = BroCatli(), bytearray()
    bc.new_brotli_file()
    bc.stream(pieces[0], out)
    state = bc.serialize_to_buffer()
    jbc = JaxBroCatli()
    jbc.new_brotli_file()
    jbc.stream(pieces[0], bytearray())
    assert len(state) == 21 and state == jbc.serialize_to_buffer()
    bc2 = BroCatli.deserialize_from_buffer(state)
    assert bc2.serialize_to_buffer() == state
    bc2.new_brotli_file()
    bc2.stream(pieces[1], out)
    assert bc2.finish(out) == BroCatliResult.Success
    assert bytes(out) == JMULTI._merge(pieces)
    bad = bytearray(state)
    bad[8] = 7   # an invalid last_bytes_len
    with pytest.raises(ValueError):
        BroCatli.deserialize_from_buffer(bytes(bad))


# ---------------------------------------------------------------------------
# Entry points and profiling
# ---------------------------------------------------------------------------


def test_entry_step_matches_jax():
    import __graft_entry__ as G
    jstep, (jdata,) = G.entry()
    step, (data,) = E.entry(device="cpu")
    np.testing.assert_array_equal(data.numpy(), np.asarray(jdata))
    want = jax.jit(jstep)(jdata)
    got = step(data)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].sum()) < len(data) and int((got[1] >= 2).sum()) > 0


def test_measure_kernel_and_device_trace_on_cpu(tmp_path):
    x = torch.arange(1 << 16, dtype=torch.int32)
    st = measure_kernel("sum", torch.sum, (x,), bytes_moved=4 << 16,
                        warmup=1, reps=2)
    assert isinstance(st, KernelStats) and st.calls == 3
    assert st.wall_s > 0 and st.gbps > 0 and st.device_s is None
    assert "[kernel] sum" in str(st)
    with device_trace(str(tmp_path / "trace")):
        torch.sum(x)
    (name,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / name) as f:
        assert "traceEvents" in json.load(f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            measure_kernel("sum", torch.sum, (x,), 0, kernel="reduce")
