"""compress_fast(device="cpu") and its matcher against brotli_tpu's.

The q0/q1 device path: best_matches_block (the hashed two-table
matcher whose lengths are the match_rounds chain), the compaction of
accepted candidates, and whole streams, byte for byte.  Inputs come
from a numpy seed (repeated phrases with near-repeats and random
bytes, so chunk words >= 2^31 are common).  Every stream decodes
through brotli_tpu's decoder and the system libbrotlidec.  Tolerance:
exact equality.

brotli_tpu's compress_fast restarts the distance cache at every shard,
so its streams of more than one shard do not decode; the port carries
the cache, and multi-shard inputs are held against the reference's own
shard loop with that one change (`_reference_carrying_cache`, built
from brotli_tpu's parts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from . import oracle
from brotli_tpu import decompress
from brotli_tpu.core.bitio import BitWriter
from brotli_tpu.encode import bitstream as JB
from brotli_tpu.encode import fast as JF
from brotli_tpu.encode.command import resolve_commands
from brotli_tpu.encode.match import greedy_parse
from brotli_tpu.encode.params import EncoderParams
from brotli_tpu.ops import matching as JM
from brotli_tpu_torch import compress_fast
from brotli_tpu_torch.encode import fast as TF
from brotli_tpu_torch.ops import match_rounds_cuda as MR
from brotli_tpu_torch.ops import matching as TM
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


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


def _check_stream(out: bytes, data: bytes):
    assert decompress(out) == data
    if oracle.available():
        assert oracle.decompress(out) == data


def test_hash_multiply_wraps_like_uint32():
    v = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF],
                 np.uint32)
    for c in (JM.HASH_MUL32, JM.HASH_MUL32B):
        got = TM.mul32(torch.from_numpy(v.astype(np.int64)), int(c))
        np.testing.assert_array_equal(got.numpy(), (v * c).astype(np.int64))
    assert (TM.HASH_MUL32, TM.HASH_MUL32B, TM.LEN_CAP) == (
        int(JM.HASH_MUL32), int(JM.HASH_MUL32B), JM.LEN_CAP)


@pytest.mark.parametrize("k,k8,bucket_bits,min_pos", [
    (2, 1, 17, 0), (8, 4, 17, 0), (4, 2, 12, 3000), (3, 0, 17, 0)])
def test_best_matches_block_matches_jax(k, k8, bucket_bits, min_pos):
    d = _data(12000, seed=k * 10 + k8)
    v1 = TM.u32_values_at(torch.from_numpy(d), 4)
    assert (v1 >= 1 << 31).any()
    window = (1 << 13) - 16
    want = JM.best_matches_block(jnp.asarray(d), window, k=k,
                                 bucket_bits=bucket_bits, k8=k8,
                                 min_pos=min_pos)
    got = TM.best_matches_block(torch.from_numpy(d), window, k=k,
                                bucket_bits=bucket_bits, k8=k8,
                                min_pos=min_pos)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() >= 4).sum() > len(d) // 4


def test_topk_prev_same_hash_matches_jax():
    d = _data(5000, seed=2)
    h = TM.mul32(TM.u32_values(torch.from_numpy(d)), TM.HASH_MUL32) >> 20
    want = JM.topk_prev_same_hash(jnp.asarray(h.numpy().astype(np.uint32)),
                                  4)
    got = TM.topk_prev_same_hash(h, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).any()


@pytest.mark.parametrize("kind", ["sparse", "phrases", "zeros", "period3"])
def test_match_compact_matches_jax(kind):
    n = 16384
    if kind == "sparse":   # random bytes with one 1000-byte repeat
        d = np.random.default_rng(4).integers(0, 256, n, dtype=np.uint8)
        d[9000:10000] = d[2000:3000]
    elif kind == "phrases":
        d = _data(n, seed=4)
    elif kind == "zeros":
        d = np.zeros(n, np.uint8)
    else:
        d = np.tile(np.array([7, 200, 31], np.uint8), n // 3 + 1)[:n]
    window = (1 << 22) - 16
    want = [np.asarray(x) for x in JF._tpu_match_compact(jnp.asarray(d),
                                                          window)]
    got = TF._gpu_match_compact(torch.from_numpy(d), window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if kind == "sparse":
        assert 0 < int(got[3]) < n // 8
    else:
        # more than n/8 positions keep: the records past n/8 drop
        assert int(got[3]) == n // 8


@pytest.mark.parametrize("quality", [0, 1])
@pytest.mark.parametrize("size", [0, 1, 3000, 4096 * 3 + 77])
def test_compress_fast_matches_jax(size, quality):
    data = _data(size, seed=size).tobytes() if size else b""
    want = JF.compress_fast(data, quality=quality)
    got = compress_fast(data, quality=quality, device="cpu")
    assert got == want
    _check_stream(got, data)


def _reference_carrying_cache(data: bytes, lgwin: int) -> bytes:
    """brotli_tpu.encode.fast.compress_fast's loop with the distance
    cache carried across shards."""
    raw = np.frombuffer(data, np.uint8)
    params = EncoderParams(quality=1, lgwin=lgwin).sanitize(len(raw))
    w = BitWriter()
    JB.write_stream_header(w, params.lgwin)
    cache = (4, 11, 15, 16)
    for s0 in range(0, len(raw), JF.SHARD):
        shard = raw[s0:s0 + JF.SHARD]
        m = len(shard)
        m_main = m // JF.SUB_BLOCK * JF.SUB_BLOCK
        bl, bd, bsc = (np.zeros(m, np.int64) for _ in range(3))
        if m_main:
            cpos, clen, cdist, count = (np.asarray(x) for x in
                                        JF._tpu_match_compact(
                                            shard[:m_main],
                                            params.window_size))
            p, ln, d = (x[:int(count)].astype(np.int64)
                        for x in (cpos, clen, cdist))
            bl[p], bd[p] = ln, d
            bsc[p] = 135 * ln - 30 * np.floor(
                np.log2(np.maximum(d, 2))).astype(np.int64)
        ins, cps, dst, adv = greedy_parse(
            shard, bl, bd, bsc, [m], initial_cache=cache,
            window_size=params.window_size)[0]
        cmds, new_cache = resolve_commands(
            ins, cps, dst, params.dist, advance=adv, initial_cache=cache,
            window_size=params.window_size)
        is_last = s0 + m == len(raw)
        state, before = w.save_state(), w.bit_length()
        JB.store_meta_block_trivial(w, shard, 0, m, is_last, cmds,
                                    params.dist)
        if w.bit_length() - before > 8 * m + 40:
            w.restore_state(state)
            JB.store_uncompressed_meta_block(w, shard.tobytes())
            if is_last:
                JB.write_empty_last_meta_block(w)
        else:
            cache = tuple(new_cache)
    return w.getvalue()


def test_compress_fast_multi_shard(monkeypatch):
    """Four shards: text, an incompressible one that falls back to an
    uncompressed metablock, text again (whose distance codes depend on
    the cache the first shard left), and one shorter than a
    sub-block."""
    monkeypatch.setattr(JF, "SHARD", 1 << 15)
    monkeypatch.setattr(TF, "SHARD", 1 << 15)
    rng = np.random.default_rng(8)
    data = (_data(1 << 15, seed=8).tobytes()
            + rng.integers(0, 256, 1 << 15, dtype=np.uint8).tobytes()
            + _data(1 << 15, seed=9).tobytes()
            + b"the last shard " * 100)
    raw_blocks = []
    store_raw = TF.bs.store_uncompressed_meta_block
    monkeypatch.setattr(TF.bs, "store_uncompressed_meta_block",
                        lambda w, b: (raw_blocks.append(len(b)),
                                      store_raw(w, b)))
    before = dict(MR.LAUNCHES)
    got = compress_fast(data, lgwin=18, device="cpu")
    assert MR.LAUNCHES == before
    assert raw_blocks == [1 << 15]
    assert got == _reference_carrying_cache(data, lgwin=18)
    _check_stream(got, data)
    # the reference itself restarts the cache per shard: its stream
    # differs from the port's and does not decode to the input
    want = JF.compress_fast(data, lgwin=18)
    assert want != got and decompress(want) != data
