"""The port's batch-decode tier against the JAX package's.

brotli_tpu_torch.ops.decode_gpu (tree build, symbol decode, the plain
step loop `batch_decode_ref`, the step probe) and
brotli_tpu_torch.decode.batch_gpu.decompress_batch_gpu(device="cpu")
against brotli_tpu.ops.decode_tpu / brotli_tpu.decode.batch_tpu on the
same inputs: streams of brotli_tpu.compress (q0-q5) and of
compress_fast over in-repo text and seeded bytes, at most 4 KiB each.
Every comparison is exact.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import brotli_tpu
from brotli_tpu.decode.batch_tpu import decompress_batch_tpu
from brotli_tpu.ops import decode_tpu as JD
from brotli_tpu_torch.decode import batch_gpu as B
from brotli_tpu_torch.decode.decoder import BrotliDecodeError
from brotli_tpu_torch.encode import fast as TF
from brotli_tpu_torch.ops import decode_gpu as D
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("lits", "nlit", "cmds", "ncmd", "end_bit", "status", "cache")


def _text(n: int, off: int = 0) -> bytes:
    """In-repo source text that the port leaves unchanged."""
    with open(os.path.join(ROOT, "brotli_tpu", "ops", "decode_tpu.py"),
              "rb") as f:
        return f.read()[off:off + n]


def _dict_words() -> bytes:
    """Runs of the static dictionary: q2-q4 streams of it are mostly
    static-dictionary references."""
    with open(os.path.join(ROOT, "brotli_tpu_torch", "data",
                           "dictionary.bin"), "rb") as f:
        d = f.read()
    return d[20000:21000] + d[60000:61000]


def _mixed_streams():
    rng = np.random.default_rng(7)
    phrases = [rng.integers(0, 256, size=int(rng.integers(3, 40)),
                            dtype=np.uint8).tobytes() for _ in range(40)]
    noisy = b"".join(phrases[i] for i in rng.integers(0, 40, 200))[:3000]
    payloads = [_text(4000), _text(1500, 9000), noisy, b"abcabd" * 300,
                _text(2500, 4000), _dict_words()]
    streams = [brotli_tpu.compress(p, quality=q)
               for p, q in zip(payloads, (0, 1, 2, 3, 4, 3))]
    streams.append(TF.compress_fast(_text(3500, 2000), device="cpu"))
    return streams


def _lanes(streams):
    lanes = []
    for s in streams:
        plan, _ = B._try_parse_stream(s)
        lanes += [seg for kind, seg in plan or [] if kind == "lane"]
    return lanes


def _corrupt(stream: bytes, seed: int) -> bytes:
    """The stream with its symbol data after the header replaced by
    seeded random bytes (the header, and so the lane, is unchanged)."""
    (lane,) = _lanes([stream])
    cut = lane.bit0 // 8 + 16
    rng = np.random.default_rng(seed)
    return stream[:cut] + rng.integers(0, 256, len(stream) - cut,
                                       dtype=np.uint8).tobytes()


def _lane_arrays(lanes):
    """The lane arrays of batch_tpu._run_device, in numpy."""
    n = len(lanes)
    lmax = max(len(ln.data) for ln in lanes)
    da_max = max(len(ln.dist_len) for ln in lanes)
    data = np.zeros((n, lmax), np.uint8)
    for j, ln in enumerate(lanes):
        data[j, :len(ln.data)] = np.frombuffer(ln.data, np.uint8)

    def stackpad(arrs, width):
        out = np.zeros((n, width), np.int32)
        for j, a in enumerate(arrs):
            out[j, :len(a)] = a
        return out

    def vec(name):
        return np.array([getattr(ln, name) for ln in lanes], np.int32)

    return [data, vec("bit0"), vec("mlen"), vec("window"), vec("npostfix"),
            vec("ndirect"), vec("cache"),
            stackpad([ln.lit_len for ln in lanes], 256),
            stackpad([ln.cmd_len for ln in lanes], 704),
            stackpad([ln.dist_len for ln in lanes], da_max),
            vec("out_prefix_len")]


def _both(lanes, max_steps=None):
    """(JAX outputs, port outputs) of one device pass, as numpy."""
    args = _lane_arrays(lanes)
    mlen_max = int(args[2].max())
    if max_steps is None:
        max_steps = 3 * mlen_max + 64
    s_lit, s_cmd = mlen_max, mlen_max // 2 + 8
    want = JD.batch_decode_device(*[jnp.asarray(a) for a in args],
                                  jnp.int32(max_steps), s_lit=s_lit,
                                  s_cmd=s_cmd)
    got = D.batch_decode_device(*[torch.from_numpy(a) for a in args],
                                max_steps, s_lit, s_cmd)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_outputs_equal(want, got):
    for name, w, g in zip(OUTPUTS, want, got):
        assert w.shape == g.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _complete_lengths(rng, a: int, nsym: int) -> np.ndarray:
    """Code lengths of a complete code on nsym random symbols (split a
    random leaf until there are nsym leaves, depth <= 15)."""
    leaves = [0]
    while len(leaves) < nsym:
        cand = [k for k, d in enumerate(leaves) if d < 15]
        k = cand[int(rng.integers(0, len(cand)))]
        d = leaves.pop(k)
        leaves += [d + 1, d + 1]
    out = np.zeros(a, np.int32)
    out[rng.choice(a, size=nsym, replace=False)] = leaves
    return out


def _tree_cases(a: int):
    rng = np.random.default_rng(a)
    rows = [_complete_lengths(rng, a, int(k))
            for k in rng.integers(2, min(a, 200), size=6)]
    one = np.zeros(a, np.int32)
    one[a // 3] = 1                       # a one-symbol (0-bit) tree
    empty = np.zeros(a, np.int32)         # no symbol at all
    holes = np.zeros(a, np.int32)         # incomplete: codes 0, 10 only
    holes[[5, a - 1]] = [1, 2]
    deep = np.zeros(a, np.int32)          # lengths 1..15 and one more 15
    deep[:16] = list(range(1, 16)) + [15]
    return np.stack(rows + [one, empty, holes, deep])


@pytest.mark.parametrize("alphabet", [256, 704, 64])
def test_tree_build_and_decode_match_jax(alphabet):
    lengths = _tree_cases(alphabet)
    jt = JD.build_tree_device(jnp.asarray(lengths))
    tt = D.build_tree_device(torch.from_numpy(lengths))
    for key in ("first", "limit", "offset", "syms", "single"):
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]),
                                      err_msg=key)
    rng = np.random.default_rng(1)
    n = lengths.shape[0]
    for _ in range(8):
        w = rng.integers(0, 1 << 32, size=n, dtype=np.int64)
        js, jb, jbad = JD._tree_decode(jt, jnp.asarray(w.astype(np.uint32)))
        ts, tb, tbad = D._tree_decode(tt, torch.from_numpy(w))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    # the incomplete row has windows that decode to no symbol
    bits = np.full(n, 0b11, np.int64)  # LSB-first "11": no code
    _, _, bad = D._tree_decode(tt, torch.from_numpy(bits))
    assert bool(bad[-2])


# ---------------------------------------------------------------------------
# The step loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mixed", "corrupt", "dictionary",
                                  "max_steps"])
def test_batch_decode_ref_matches_jax(case):
    streams = _mixed_streams()
    max_steps = None
    if case == "corrupt":
        streams = [streams[2], _corrupt(streams[2], seed=3), streams[3],
                   _corrupt(streams[5], seed=4)]
    elif case == "dictionary":
        streams = [streams[5], brotli_tpu.compress(_dict_words()[500:],
                                                   quality=2)]
    elif case == "max_steps":
        max_steps = 150
    lanes = _lanes(streams)
    want, got = _both(lanes, max_steps)
    _assert_outputs_equal(want, got)
    status = got[5]
    if case == "mixed":
        assert len(lanes) >= 5 and (status == D.PH_DONE).sum() >= 5
        assert len(set(got[1].tolist())) == len(lanes)  # mixed lengths
    elif case == "corrupt":
        assert status[1] != D.PH_DONE and status[3] != D.PH_DONE
        assert status[0] == status[2] == D.PH_DONE
    elif case == "dictionary":
        assert (status == D.PH_DONE).all()
        for j in range(len(lanes)):   # distances past the output so far
            cmds = got[2][j, :got[3][j]]
            pos = np.cumsum(cmds[:, 0]) + np.concatenate(
                [[0], np.cumsum(cmds[:-1, 1])])
            assert (cmds[:, 2] > pos).sum() > 50
    else:
        assert (status < D.PH_DONE).any()


def test_steps_out_counts_live_steps():
    lanes = _lanes(_mixed_streams()[:4])
    args = [torch.from_numpy(a) for a in _lane_arrays(lanes)]
    mlen_max = int(args[2].max())
    steps = torch.zeros(len(lanes), dtype=torch.int32)
    D.batch_decode_device(*args, 40, mlen_max, mlen_max // 2 + 8,
                          steps_out=steps)
    short = torch.zeros(len(lanes), dtype=torch.int32)
    out = D.batch_decode_device(*args, 3 * mlen_max + 64, mlen_max,
                                mlen_max // 2 + 8, steps_out=short)
    assert (steps <= 40).all() and (steps == 40).any()
    assert (short >= steps).all()
    assert (out[5] == D.PH_DONE).all()


def test_batch_decode_device_runs_the_plain_loop_on_cpu():
    lanes = _lanes(_mixed_streams()[:2])
    args = [torch.from_numpy(a) for a in _lane_arrays(lanes)]
    before = dict(D.LAUNCHES)
    D.batch_decode_device(*args, 100, 4000, 2008)
    assert D.LAUNCHES == before
    with pytest.raises(ValueError):
        D.batch_decode_device(args[0][:, :0], *args[1:], 100, 4000, 2008)


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------


def _check_entry(streams, n_device=None):
    want, wn = decompress_batch_tpu(streams)
    got, gn = B.decompress_batch_gpu(streams, device="cpu")
    assert got == want
    assert gn == wn
    if n_device is not None:
        assert gn == n_device
    return got, gn


def test_decompress_batch_gpu_matches_jax_q0_q5():
    payloads = [_text(3000, 500 * q) for q in range(6)] + [_dict_words()]
    streams = [brotli_tpu.compress(p, quality=q)
               for q, p in enumerate(payloads[:6])]
    streams.append(brotli_tpu.compress(payloads[6], quality=2))
    streams.append(TF.compress_fast(_text(4000, 100), device="cpu"))
    got, n_device = _check_entry(streams)
    assert got == payloads + [_text(4000, 100)]
    assert n_device >= 4


def test_decompress_batch_gpu_matches_jax_multi_metablock(monkeypatch):
    """compress_fast with 2 KiB shards: several compressed metablocks per
    stream, decoded over several device rounds through the resumable
    walk."""
    monkeypatch.setattr(TF, "SHARD", 1 << 11)
    payloads = [_text(7000, 300), _text(5000, 9000)]
    streams = [TF.compress_fast(p, lgwin=18, device="cpu")
               for p in payloads]
    rounds = []
    run = B._run_device
    monkeypatch.setattr(B, "_run_device",
                        lambda lanes, dev: (rounds.append(len(lanes)),
                                            run(lanes, dev))[1])
    got, _ = _check_entry(streams, n_device=2)
    assert got == payloads
    assert len(rounds) >= 3


def test_decompress_batch_gpu_walk_only_and_corrupt_streams():
    good = b"\x3b"  # lgwin 22 header + ISLAST + ISLASTEMPTY
    assert _check_entry([good], n_device=0)[0] == [b""]
    with pytest.raises(BrotliDecodeError):
        B.decompress_batch_gpu([bytes([good[0] | 0x80])], device="cpu")
    s = brotli_tpu.compress(_text(3000), quality=2)
    bad = _corrupt(s, seed=5)
    with pytest.raises(BrotliDecodeError):
        B.decompress_batch_gpu([bad], device="cpu")
    with pytest.raises(brotli_tpu.BrotliDecodeError):
        decompress_batch_tpu([bad])


@pytest.mark.parametrize("quality", [2, 3])
def test_decompress_batch_gpu_rejects_dirty_padding(quality):
    """RFC 7932 section 9.2 on the device tier: nonzero final padding
    is rejected as the host decoder rejects it."""
    payload = _text(4096, 1000)
    s = brotli_tpu.compress(payload, quality=quality)
    assert _check_entry([s], n_device=1)[0] == [payload]
    bad = s[:-1] + bytes([s[-1] | 0x80])
    try:
        host = brotli_tpu.decompress(bad)
    except brotli_tpu.BrotliDecodeError:
        host = None
    if host is None:
        with pytest.raises(BrotliDecodeError):
            B.decompress_batch_gpu([bad], device="cpu")
        with pytest.raises(brotli_tpu.BrotliDecodeError):
            decompress_batch_tpu([bad])
    else:
        assert _check_entry([bad])[0] == [host]


# ---------------------------------------------------------------------------
# TPU probe #9
# ---------------------------------------------------------------------------


def _probe_module():
    path = os.path.join(ROOT, "research", "decode_step_kernel_probe.py")
    spec = importlib.util.spec_from_file_location("decode_step_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("reads", [0, 1, 2])
def test_step_probe_ref_matches_probe_kernel(reads, monkeypatch):
    """step_probe_ref against the probe's own Pallas kernel body, run in
    interpret mode with the module's STEPS cut to 6."""
    probe = _probe_module()
    monkeypatch.setattr(probe, "STEPS", 6)
    rng = np.random.default_rng(reads)
    tab = rng.integers(-(1 << 31), 1 << 31, size=(probe.LANES, 1056),
                       dtype=np.int64).astype(np.int32)
    st = rng.integers(-(1 << 31), 1 << 31, size=(1, probe.LANES),
                      dtype=np.int64).astype(np.int32)
    kernel = pl.pallas_call(
        probe.make_kernel(reads),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, probe.LANES), jnp.int32),
        interpret=True)
    want = np.asarray(kernel(jnp.asarray(tab), jnp.asarray(st)))
    before = dict(D.LAUNCHES)
    got = D.step_probe(torch.from_numpy(tab), torch.from_numpy(st), 6, reads)
    assert D.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), want)


def test_native_decode_pools_and_matches_reference(monkeypatch):
    """The port's native one-shot decode keeps its 32 MiB table and an
    output buffer of up to 64 MiB across calls, as the JAX package's
    does, and equals it: small streams, an output that outgrows the
    first 4 MiB buffer, one past the pool's 64 MiB, and a corrupt
    stream followed by a good one."""
    from brotli_tpu import native_bridge as jnb
    from brotli_tpu_torch import native_bridge as tnb

    from . import oracle
    text = open(os.path.join(ROOT, "native", "decoder.cpp"), "rb").read()
    streams = [oracle.compress(text[:n], quality=q, lgwin=22)
               for n, q in ((0, 1), (1000, 5), (len(text), 9))]
    big = (text * ((9 << 20) // len(text) + 1))[:9 << 20]
    streams.append(oracle.compress(big, quality=1, lgwin=22))
    streams.append(oracle.compress(bytes(72 << 20), quality=1, lgwin=24))
    good = streams[1]
    corrupt = good[:8] + bytes(b ^ 0x5A for b in good[8:])
    monkeypatch.setattr(tnb, "_decode_out", None)
    table = None
    for s in streams + [corrupt, good]:
        try:
            want = jnb.decode(s)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tnb.decode(s)
            assert got.value.args == e.args
            continue
        assert tnb.decode(s) == want
        table = table if table is not None else tnb._table_mem
        assert tnb._table_mem is table
    assert len(tnb._decode_out) == 32 << 20   # grew 8x from 4 MiB, once
