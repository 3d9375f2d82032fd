"""brotli_tpu_torch on the card: the CUDA kernels (fold, also at the
edges of its design, the static-dictionary probe, match_rounds in both
forms, decode_step, step_probe on its plan's grid, the radix probes'
five primitives, hist8 also on its edge inputs) against their plain
versions, the latency probe, and the compress, multi-shard and
batch-decode paths, the shard pipelines and the entry points on CUDA
against the CPU;
the fold mirrors of ops/matching.py on the card against their CPU
results and against the CUDA tier wrappers.

Marked `cuda`; each test skips where torch.cuda.is_available() is
false.  On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda

This file imports neither jax nor brotli_tpu, so it runs where only
the port is installed.  Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from brotli_tpu_torch import (compress_fast, compress_gpu, compress_mesh,
                              decompress_batch_gpu, make_mesh)
from brotli_tpu_torch import entry as E
from brotli_tpu_torch.decode import batch_gpu as B
from brotli_tpu_torch.ops import decode_gpu as D
from brotli_tpu_torch.ops import dict_probe_cuda as DP
from brotli_tpu_torch.ops import fold_cuda as F
from brotli_tpu_torch.ops import match_rounds_cuda as MR
from brotli_tpu_torch.ops import matching as TM
from brotli_tpu_torch.ops import radix_cuda as RC
from brotli_tpu_torch.parallel import mesh as M
from brotli_tpu_torch.research import hist8_ab as H8
from brotli_tpu_torch.research.corpus import ROOT, make_corpus

from .fold_edges import CASES as FOLD_CASES
from .fold_edges import CONFIGS as FOLD_CONFIGS
from .fold_edges import edge_case

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _data(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    phrases = [rng.integers(0, 256, size=int(rng.integers(3, 64)),
                            dtype=np.uint8) for _ in range(200)]
    pick = rng.integers(0, len(phrases), size=n // 8)
    return np.concatenate([phrases[i] for i in pick])[:n]


@pytest.mark.parametrize("min_pos", [0, 7777])
@pytest.mark.parametrize("config", [(1, 1, 32, 0, False),
                                    (2, 0, 16, 8, False),
                                    (2, 2, 16, 8, False),
                                    (1, 1, 16, 0, False),
                                    (2, 2, 16, 8, True),
                                    (1, 5, 32, 0, False),
                                    (1, 5, 16, 0, False),
                                    (1, 3, 32, 0, False)])
def test_fold_kernel_matches_ref(config, min_pos):
    dev = _card()
    n_keys, n_pay, k_fwd, k_back, fuse = config
    row = torch.from_numpy(_data(100_003, seed=1)).to(dev)
    if n_keys == 1:
        ops = F._sort_v0(row, [F.u32_values_at(row, 4 * r)
                               for r in range(1, n_pay + 1)])
    else:
        ops = F._sort_v0v1(row, n_pay + 2)
    kw = dict(n_keys=n_keys, k_fwd=k_fwd, k_back=k_back, window=1 << 16,
              lbs=135, len_shift=26, n_real=row.shape[0],
              fuse_short=fuse)
    before = sum(F.LAUNCHES.values())
    packed, score = F.fold_sorted(ops, min_pos, **kw)
    assert sum(F.LAUNCHES.values()) == before + 1
    rp, rs = F.fold_sorted_ref(ops, min_pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(packed, rp)
    assert torch.equal(score, rs)
    assert int((packed != 0).sum()) > 0


@pytest.mark.parametrize("mid", [False, True])
@pytest.mark.parametrize("case", FOLD_CASES)
@pytest.mark.parametrize("config", FOLD_CONFIGS)
def test_fold_kernel_edges(config, case, mid):
    """The seven folds on inputs at the design's edges (tests/
    fold_edges.py: a v0 run longer than a tile, runs across tile edges,
    fewer rows than a tile, a short window, limit capping lengths), at
    min_pos 0 and mid-row: launched once on fold_plan's grid and equal
    to the plain version."""
    dev = _card()
    n_keys, n_pay, k_fwd, k_back, fuse = config
    data, window, n_real = edge_case(case)
    row = torch.from_numpy(data).to(dev)
    if n_keys == 1:
        ops = F._sort_v0(row, [F.u32_values_at(row, 4 * r)
                               for r in range(1, n_pay + 1)])
    else:
        ops = F._sort_v0v1(row, n_pay + 2)
    min_pos = len(data) // 2 if mid else 0
    kw = dict(n_keys=n_keys, k_fwd=k_fwd, k_back=k_back, window=window,
              lbs=135, len_shift=26, n_real=n_real, fuse_short=fuse)
    before = sum(F.LAUNCHES.values())
    packed, score = F.fold_sorted(ops, min_pos, **kw)
    assert sum(F.LAUNCHES.values()) == before + 1
    assert F.LAST_PLAN == F.fold_plan(len(data), n_keys, n_pay, k_fwd,
                                      k_back, fuse)
    rp, rs = F.fold_sorted_ref(ops, min_pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(packed, rp)
    assert torch.equal(score, rs)


# (mirror, its arguments, the tier wrapper computing the same function)
MIRRORS = [
    ("packed", dict(k=8, k8=4, rounds=4), None),
    ("fused", dict(k=16, k8=8, rounds=4), None),
    ("exact", dict(k=16, k8=8, rounds=2), None),
    ("exact", dict(k=32, k8=0, rounds=2), dict(k=32, rounds=2)),
    ("exact8", dict(k=16, rounds=2), dict(k=16, rounds=2)),
    ("exact9", dict(k=16, k_short=16, rounds=4),
     dict(k=16, k_short=16, rounds=4)),
]


@pytest.mark.parametrize("min_pos", [0, 7777])
@pytest.mark.parametrize("name,kw,wkw", MIRRORS)
def test_fold_mirror_card_matches_cpu(name, kw, wkw, min_pos):
    """Each fold mirror on the card equals its CPU result; the tier
    mirrors also equal the CUDA tier wrappers, which launch the fold."""
    dev = _card()
    row = torch.from_numpy(_data(100_003, seed=2))
    fn = getattr(TM, "best_matches_" + name)
    got = fn(row.to(dev), 1 << 16, min_pos=min_pos, **kw)
    want = fn(row, 1 << 16, min_pos=min_pos, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device == dev
        assert torch.equal(g.cpu(), w)
    assert int((want[0] != 0).sum()) > 0
    if wkw is not None:
        before = sum(F.LAUNCHES.values())
        p = getattr(F, f"best_matches_{name}_p")(row.to(dev), 1 << 16,
                                                min_pos=min_pos, **wkw)
        assert sum(F.LAUNCHES.values()) > before
        assert torch.equal(p, got[0])


@pytest.mark.parametrize("quality", [5, 7, 9])
def test_compress_gpu_card_matches_cpu(quality):
    dev = _card()
    data = _data(300_000, seed=quality).tobytes()
    got = compress_gpu(data, quality=quality, span=1 << 16, device=dev)
    assert got == compress_gpu(data, quality=quality, span=1 << 16,
                               device="cpu")


# (row bytes, halo, real, min_pos, window): a bulk file's 4,718,592-byte
# row (lgwin 22, a whole 512 KiB span), and web-sized rows at lgwin 15
# (a first span, and a later one whose halo is half filled), of the bulk
# mix in 64 KiB blocks of a seeded order
DICT_ROWS = {"bulk": (4_718_592, 4_194_304, 524_288, 0, (1 << 22) - 16),
             "web": (557_056, 32_768, 100_000, 32_768, (1 << 15) - 16),
             "web_later": (557_056, 32_768, 50_001, 16_384,
                           (1 << 15) - 16)}


def _mix(n: int, seed: int) -> np.ndarray:
    """n bytes of the bulk mix (research/corpus.py) in 64 KiB blocks of
    a seeded order."""
    corpus = np.frombuffer(make_corpus(-(-n >> 20) + 1, seed), np.uint8)
    blocks = corpus[:len(corpus) >> 16 << 16].reshape(-1, 1 << 16)
    order = np.random.default_rng(seed).permutation(len(blocks))
    return np.ascontiguousarray(blocks[order].ravel()[:n])


@pytest.mark.parametrize("shape", list(DICT_ROWS))
def test_dict_probe_kernel_matches_ref(shape):
    """The probe's output equals its plain version's on the card in
    every word it defines: each block's candidates and its count."""
    dev = _card()
    n, halo, real, min_pos, window = DICT_ROWS[shape]
    row = _mix(n, seed=len(shape))
    row[halo + real:] = 0          # a short last span's zero tail
    row_d = torch.from_numpy(row).to(dev)
    before = DP.LAUNCHES
    got = DP.dict_probe(row_d, halo, real, min_pos, window)
    assert DP.LAUNCHES == before + 1
    want = DP.dict_probe_ref(row_d, halo, real, min_pos, window)
    torch.cuda.synchronize()
    span = n - halo
    assert got.shape == (span + DP.probe_plan(span)["ctas"],)
    (gc, gw), (wc, ww) = (DP.candidates(t.cpu().numpy())
                          for t in (got, want))
    assert np.array_equal(gc, wc) and np.array_equal(gw, ww)
    assert len(gw) > 100


def test_dict_probe_launches_once_per_dispatch():
    """compress_gpu probes each span once on the card; max_device, which
    has no dictionary, never."""
    dev = _card()
    data = _data(300_000, seed=3).tobytes()
    for quality in (2, 5, 7, 9):
        before = DP.LAUNCHES
        compress_gpu(data, quality=quality, span=1 << 16, device=dev)
        assert DP.LAUNCHES - before == -(-len(data) // (1 << 16))
    before = DP.LAUNCHES
    compress_gpu(data, quality=5, span=1 << 16, max_device=True, device=dev)
    assert DP.LAUNCHES == before


@pytest.mark.parametrize("quality", [5, 7, 9])
def test_compress_gpu_card_matches_cpu_on_text(quality):
    """Dictionary-dense English text (the repo's docs): the dictionary
    takes many positions, and the card's stream equals the CPU's."""
    dev = _card()
    data = b"".join(open(f"{ROOT}/{name}", "rb").read()
                    for name in ("SURVEY.md", "README.md"))
    stats = {}
    got = compress_gpu(data, quality=quality, span=1 << 15, stats=stats,
                       device=dev)
    assert stats["dict.won"] > len(data) // 100
    assert got == compress_gpu(data, quality=quality, span=1 << 15,
                               device="cpu")


@pytest.mark.parametrize("quality", [5, 9])
def test_compress_mesh_card_matches_cpu(quality):
    """Four shards on the card (make_mesh's default placement) against
    the same shards on the host; every shard launches its folds."""
    _card()
    data = _data(300_000, seed=40 + quality).tobytes()
    before = sum(F.LAUNCHES.values())
    got = compress_mesh(data, n_shards=4, quality=quality, lgwin=16)
    assert sum(F.LAUNCHES.values()) - before == (4 if quality <= 6 else 8)
    assert got == compress_mesh(data, n_shards=4, quality=quality, lgwin=16,
                                device="cpu")


@pytest.mark.parametrize("rounds,m", [(1, 1), (4, 1000), (8, 100_003)])
def test_match_rounds_kernel_matches_ref(rounds, m):
    dev = _card()
    rng = np.random.default_rng(rounds)
    va = rng.integers(-(1 << 31), 1 << 31, size=(rounds, m), dtype=np.int64)
    vb = va.copy()
    # candidate i equals in its first i % (rounds + 1) rounds, then
    # differs in one random byte of the next round
    eq = np.arange(m) % (rounds + 1)
    for r in range(rounds):
        hit = eq == r
        vb[r, hit] ^= 1 << (8 * rng.integers(0, 4, size=int(hit.sum())))
    va_t = torch.from_numpy(va.astype(np.int32)).to(dev)
    vb_t = torch.from_numpy(vb.astype(np.int32)).to(dev)
    before = MR.LAUNCHES.get("match_rounds", 0)
    got = MR.match_rounds(va_t, vb_t)
    assert MR.LAUNCHES["match_rounds"] == before + 1
    want = MR.match_rounds_ref(va_t, vb_t)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _periodic_rounds(rounds: int, m: int, period: int,
                     seed: int) -> np.ndarray:
    """int32 [rounds, m]: a random column repeated every `period` rows,
    8% of the words with a byte flipped and 5% zero, so that the chains
    at multiples of the period run long and all chains stop in every
    round."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 1 << 32, size=(rounds, period), dtype=np.uint64)
    va = np.tile(base, (1, m // period + 1))[:, :m].copy()
    flip = rng.random((rounds, m)) < 0.08
    n = int(flip.sum())
    va[flip] ^= rng.integers(1, 256, n, dtype=np.uint64) \
        << (8 * rng.integers(0, 4, n, dtype=np.uint64))
    va[rng.random((rounds, m)) < 0.05] = 0
    return va.astype(np.uint32).view(np.int32)


def _fold_form_launches() -> dict:
    return {k: MR.LAUNCHES.get(f"match_rounds_shifted_k{k}", 0)
            for k in range(1, MR.MAX_K + 1)}


def test_shard_pipelines_card_match_cpu():
    """sharded_pipeline and match_pipeline over two shards on the card
    against the same on the host; each shard runs best_matches_block
    (k = 4, k8 = 2): one fold-form launch at k = 4 and one at k = 2."""
    _card()
    blocks = _data(2 * 8192, seed=61).reshape(2, 8192)
    window = (1 << 16) - 16
    for make in (M.sharded_pipeline, M.match_pipeline):
        before = _fold_form_launches()
        got = make(make_mesh(2), window)(blocks)
        delta = {k: n - before[k] for k, n in _fold_form_launches().items()
                 if n != before[k]}
        assert delta == {4: 2, 2: 2}
        want = make(make_mesh(2, device="cpu"), window)(blocks)
        assert got[0].device.type == "cuda"
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert int(got[-1]) > 0


def test_entry_step_card_matches_cpu():
    """entry()'s step on the card (its default) launches the fold once
    and gives the arrays of entry(device="cpu")'s step."""
    _card()
    step, (data,) = E.entry()
    assert data.device.type == "cuda"
    before = sum(F.LAUNCHES.values())
    got = step(data)
    assert sum(F.LAUNCHES.values()) == before + 1
    cstep, (cdata,) = E.entry(device="cpu")
    for g, w in zip(got, cstep(cdata)):
        assert torch.equal(g.cpu(), w)


def test_dryrun_multichip_card_matches_cpu():
    """dryrun_multichip(8) on the card (eight shards on one card, each
    with its two q9 folds) round-trips and equals the host run."""
    _card()
    before = sum(F.LAUNCHES.values())
    out = E.dryrun_multichip(8)
    assert sum(F.LAUNCHES.values()) - before == 16
    assert out == E.dryrun_multichip(8, device="cpu")


@pytest.mark.parametrize("m", [1, 31, 32, 33, 100_003])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_match_rounds_shifted_kernel_matches_ref(k, m):
    """The fold form at the warp's edges: lanes < j take their left
    word from the halo the warp's first k lanes load."""
    dev = _card()
    va = torch.from_numpy(_periodic_rounds(8, m, min(k, 3), seed=k * m)) \
        .to(dev)
    before = MR.LAUNCHES.get("match_rounds_shifted", 0)
    got = MR.match_rounds_shifted(va, k)
    assert MR.LAUNCHES["match_rounds_shifted"] == before + 1
    assert MR.LAST_PLAN["k"] == k and MR.LAST_PLAN["rows"] == m
    want = MR.match_rounds_shifted_ref(va, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if m > 1000:
        assert int((want == 32).sum()) > 0 and int((want < 4).sum()) > 0


def test_compress_fast_card_matches_cpu():
    dev = _card()
    data = _data(300_000, seed=3).tobytes()
    before = dict(MR.LAUNCHES)
    got = compress_fast(data, device=dev)
    # one shard: one fold-form launch for each of its two folds
    assert MR.LAUNCHES.get("match_rounds_shifted", 0) \
        == before.get("match_rounds_shifted", 0) + 2
    assert MR.LAUNCHES.get("match_rounds", 0) \
        == before.get("match_rounds", 0)
    assert got == compress_fast(data, device="cpu")


@pytest.mark.parametrize("quality", [5, 9])
def test_max_device_card_matches_cpu(quality):
    dev = _card()
    data = _data(300_000, seed=quality).tobytes()
    got = compress_gpu(data, quality=quality, span=1 << 16,
                       max_device=True, device=dev)
    assert got == compress_gpu(data, quality=quality, span=1 << 16,
                               max_device=True, device="cpu")


def _decode_streams(count: int, seed: int):
    """compress_fast streams of seeded slices (up to 4 KiB) of in-repo
    source text, the second one with its symbol data after the header
    replaced by random bytes (its lane falls back)."""
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "decoder.cpp")
    with open(path, "rb") as f:
        text = f.read()
    rng = np.random.default_rng(seed)
    streams = []
    for _ in range(count):
        off = int(rng.integers(0, len(text) - 4096))
        streams.append(compress_fast(
            text[off:off + int(rng.integers(2048, 4096))], device="cpu"))
    plan, _ = B._try_parse_stream(streams[1])
    cut = plan[-1][1].bit0 // 8 + 16
    streams[1] = streams[1][:cut] + rng.integers(
        0, 256, len(streams[1]) - cut, dtype=np.uint8).tobytes()
    return streams


def test_decode_step_kernel_matches_ref():
    dev = _card()
    lanes = []
    for s in _decode_streams(16, seed=40):
        plan, _ = B._try_parse_stream(s)
        lanes += [seg for kind, seg in plan if kind == "lane"]
    assert len(lanes) == 16
    args, max_steps, s_lit, s_cmd = B.lane_arrays(lanes, dev)
    before = D.LAUNCHES.get("decode_step", 0)
    steps = torch.zeros(16, dtype=torch.int32, device=dev)
    got = D.batch_decode_device(*args, max_steps, s_lit, s_cmd,
                                steps_out=steps)
    assert D.LAUNCHES["decode_step"] == before + 1
    ref_steps = torch.zeros_like(steps)
    want = D.batch_decode_ref(*args, max_steps, s_lit, s_cmd,
                              steps_out=ref_steps)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(steps, ref_steps)
    # the plain version's graph replays on the card equal its eager run
    # on the CPU
    cpu_steps = torch.zeros(16, dtype=torch.int32)
    on_cpu = D.batch_decode_ref(*[a.cpu() for a in args], max_steps, s_lit,
                                s_cmd, steps_out=cpu_steps)
    for w, c in zip(want, on_cpu):
        assert torch.equal(w.cpu(), c)
    assert torch.equal(ref_steps.cpu(), cpu_steps)
    status = got[5].tolist()
    assert status[1] != D.PH_DONE
    assert status.count(D.PH_DONE) == 15


def _edge_lanes():
    """The 16 lanes of _decode_streams (the second one's bits flipped)
    and 3 of native q3 streams of 32 KiB of in-repo text, whose trees
    have codes longer than the kernel's root tables."""
    import os

    from brotli_tpu_torch.research.decode_batches import (lanes_of,
                                                          native_encoder)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "decoder.cpp")
    with open(path, "rb") as f:
        text = f.read()
    enc = native_encoder()
    streams = _decode_streams(16, seed=40)
    streams += [enc(text[k << 15:(k + 1) << 15], 3) for k in range(3)]
    return lanes_of(streams)


def _kernel_equals_ref(lanes, max_steps=None):
    """The kernel against batch_decode_ref in all seven outputs and the
    step counts."""
    dev = _card()
    args, cap, s_lit, s_cmd = B.lane_arrays(lanes, dev)
    cap = cap if max_steps is None else max_steps
    n = len(lanes)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    before = D.LAUNCHES.get("decode_step", 0)
    got = D._decode_step_cuda(*args, cap, s_lit, s_cmd, steps)
    assert D.LAUNCHES["decode_step"] == before + 1
    ref_steps = torch.zeros_like(steps)
    want = D.batch_decode_ref(*args, cap, s_lit, s_cmd, steps_out=ref_steps)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(steps, ref_steps)
    return got, steps


def _one_symbol_lanes():
    """Lanes of repetitive inputs, whose trees have one symbol (0-bit
    codes) in every kind."""
    from brotli_tpu_torch.research.decode_batches import (lanes_of,
                                                          native_encoder)
    enc = native_encoder()
    inputs = [b"a" * 5000, b"ab" * 4000, b"abcd" * 3000]
    lanes = lanes_of([enc(d, q) for d in inputs for q in (1, 3)]
                     + [compress_fast(d, device="cpu") for d in inputs])
    singles = [sum(int((np.asarray(x) > 0).sum()) == 1 for x in
                   (ln.lit_len, ln.cmd_len, ln.dist_len)) for ln in lanes]
    assert max(singles) == 3
    return lanes


@pytest.mark.parametrize("case", ["long codes", "half the median steps",
                                  "a partly empty last CTA",
                                  "one-symbol trees"])
def test_decode_step_kernel_edges(case):
    if case == "one-symbol trees":
        got, _ = _kernel_equals_ref(_one_symbol_lanes())
        assert (got[5] == D.PH_DONE).all()
        return
    lanes = _edge_lanes()
    longest = [max(int(max(getattr(ln, k))) - b for ln in lanes)
               for k, b in zip(("lit_len", "cmd_len", "dist_len"),
                               D.LUT_BITS)]
    assert min(longest) > 0   # every tree kind has codes past its table
    if case == "long codes":
        got, _ = _kernel_equals_ref(lanes)
        status = got[5].tolist()
        assert status[1] != D.PH_DONE
        assert status.count(D.PH_DONE) == len(lanes) - 1
    elif case == "half the median steps":
        _, steps = _kernel_equals_ref(lanes)
        cap = int(steps.float().median()) // 2
        got, _ = _kernel_equals_ref(lanes, max_steps=cap)
        assert int((got[5] < D.PH_DONE).sum()) > 0
    else:
        # 8 sms + 5 lanes: 8 lanes a CTA, the last CTA holds 5 of them
        sms = D._sm_count(_card().index or 0)
        n = 8 * sms + 5
        _kernel_equals_ref([lanes[k % 13] for k in range(n)])
        plan = D.LAST_PLAN
        assert plan["lanes"] == n and plan["lanes_per_cta"] == 8
        assert plan["ctas"] == sms + 1


def test_decode_step_plan_covers_every_sm():
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = D.decode_step_plan(1024, sms)
    assert plan["ctas"] >= sms


def _probe_inputs(lanes: int, width: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31,
                                        size=(lanes, width), dtype=np.int64)
                           .astype(np.int32)).to(dev)
    st = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(1, lanes),
                                       dtype=np.int64).astype(np.int32))
    return tab, st.to(dev)


@pytest.mark.parametrize("reads", [0, 1, 2])
def test_step_probe_kernel_matches_ref(reads):
    dev = _card()
    tab, st = _probe_inputs(128, 1056, reads, dev)
    before = D.LAUNCHES.get("step_probe", 0)
    got = D.step_probe(tab, st, 64, reads)
    assert D.LAUNCHES["step_probe"] == before + 1
    assert torch.equal(got, D.step_probe_ref(tab, st, 64, reads))


@pytest.mark.parametrize("lanes", [1, 127, 128, 129, 1000])
@pytest.mark.parametrize("reads", [0, 1, 2])
def test_step_probe_kernel_edges(reads, lanes):
    """Lane counts about a CTA an SM, rows that are not 16-byte aligned
    (width 1024 + reads), and 0, 1 and 2048 steps, on the plan's grid."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for width in (1024 + reads, 1056, 4096):
        tab, st = _probe_inputs(lanes, width, lanes * width + reads, dev)
        for steps in (0, 1, 2048):
            got = D.step_probe(tab, st, steps, reads)
            assert D.LAST_PROBE_PLAN == dict(
                D.step_probe_plan(lanes, width, sms), lanes=lanes,
                width=width, reads=reads)
            want = D.step_probe_ref(tab, st, steps, reads)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (width, steps)


def test_step_probe_rejects_what_the_plan_cannot_hold():
    dev = _card()
    too_wide = D.SMEM_MAX // 4 + 1
    tab, st = _probe_inputs(2, too_wide, 0, dev)
    with pytest.raises(ValueError):
        D.step_probe(tab, st, 8, 1)
    tab, st = _probe_inputs(2, 1056, 0, dev)
    with pytest.raises(ValueError):
        D.step_probe(tab, st, 8, 3)


def test_latency_probe_and_clock():
    dev = _card()
    lat = D.latency_probe(dev)
    assert set(lat) == {"IMAD", "LOP3", "IADD3", "LDS"}
    assert all(1 <= v < 200 for v in lat.values()), lat
    assert D.sm_clock_khz(dev.index or 0) > 100_000


def test_decompress_batch_gpu_card_matches_cpu():
    dev = _card()
    streams = _decode_streams(9, seed=50)
    del streams[1]
    before = D.LAUNCHES.get("decode_step", 0)
    got = decompress_batch_gpu(streams, device=dev)
    assert D.LAUNCHES["decode_step"] == before + 1
    assert got == decompress_batch_gpu(streams, device="cpu")
    assert got[1] == 8


def test_decompress_batch_gpu_google_streams_walk_natively(monkeypatch):
    """A serving-shaped batch: google's q1 and q3 (libbrotlienc, lgwin
    22) of seeded 64 KiB slices of in-repo source text.  Every walk is
    native, the first and the resume of each stream that pauses at a
    non-final compressed metablock (every q1 stream); outputs and
    n_device equal the route with every walk in Python, and the
    plaintext."""
    import glob
    import os

    from brotli_tpu_torch import native_bridge as nb

    from . import oracle
    dev = _card()
    if not oracle.available():
        pytest.skip("libbrotlienc is needed for google's streams")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    text = b"".join(open(f, "rb").read() for f in
                    sorted(glob.glob(os.path.join(root, "native", "*.cpp"))))
    rng = np.random.default_rng(60)
    plain = []
    for _ in range(32):
        off = int(rng.integers(0, len(text) - (1 << 16)))
        plain.append(text[off:off + (1 << 16)])
    streams = [oracle.compress(p, quality=1 if i % 2 == 0 else 3, lgwin=22)
               for i, p in enumerate(plain)]
    pending = [B._try_parse_stream(s)[1] for s in streams]
    assert all(pending[0::2])
    stats = {}
    got = decompress_batch_gpu(streams, device=dev, stats=stats)
    assert got == (plain, len(streams))
    assert stats["walks_python"] == stats["walks_resumed"] == 0
    assert stats["walks_native"] == len(streams) + sum(pending)
    monkeypatch.setattr(nb, "lane_walk", lambda *a: None)
    py_stats = {}
    assert decompress_batch_gpu(streams, device=dev, stats=py_stats) == got
    assert py_stats["walks_native"] == 0
    assert py_stats["walks_python"] == len(streams)
    assert py_stats["walks_resumed"] == sum(pending)


def _rows(rng, rows, narrow=False):
    x = rng.integers(-(1 << 31), 1 << 31, size=(rows, 128), dtype=np.int64)
    return (x % 5 if narrow else x).astype(np.int32)


def _launched_once(key, fn, *args):
    before = RC.LAUNCHES.get(key, 0)
    out = fn(*args)
    assert RC.LAUNCHES[key] == before + 1
    torch.cuda.synchronize()
    return out


def _index(rng, shape, high, kind):
    """int32 indices in [0, high): all 0, all high - 1, each lane's own
    reversed (127 - l, along the lanes) or seeded."""
    if kind == "zeros":
        return np.zeros(shape, np.int32)
    if kind == "last":
        return np.full(shape, high - 1, np.int32)
    if kind == "reversed":
        return np.broadcast_to(127 - np.arange(128, dtype=np.int32),
                               shape).copy()
    return rng.integers(0, high, size=shape, dtype=np.int32)


# gather_rows on rows a multiple of R, with every index kind, at R = 1
# ... 40960: the smem route to 2048 (strips of 128 down to 8 lanes, among
# them non-powers of two), the l2 route beyond
GATHER_CASES = [(r, kind)
                for r in (1, 8, 24, 32, 256, 1024, 2048, 4096, 5001, 8192,
                          12000, 40960)
                for kind in ("seeded", "zeros", "last")]


@pytest.mark.parametrize("r,kind", GATHER_CASES)
def test_gather_rows_kernel_matches_ref(r, kind):
    dev = _card()
    rng = np.random.default_rng(r)
    rows = r * -(-16384 // r)
    x = torch.from_numpy(_rows(rng, rows)).to(dev)
    idx = torch.from_numpy(_index(rng, (rows, 128), r, kind)).to(dev)
    got = _launched_once(f"gather_rows_R{r}", RC.gather_rows, x, idx, r)
    assert torch.equal(got, RC.gather_rows_ref(x, idx, r))


# 1001 rows end in a ragged row group; 40993 also make the warps of a
# card's 8 CTAs an SM stride over more rows
@pytest.mark.parametrize("rows", [1001, 40993])
@pytest.mark.parametrize("kind", ["seeded", "reversed", "zeros"])
def test_gather_lanes_kernel_matches_ref(kind, rows):
    dev = _card()
    rng = np.random.default_rng(21)
    x = torch.from_numpy(_rows(rng, rows)).to(dev)
    idx = torch.from_numpy(_index(rng, (rows, 128), 128, kind)).to(dev)
    got = _launched_once("gather_lanes", RC.gather_lanes, x, idx)
    assert torch.equal(got, RC.gather_lanes_ref(x, idx))


@pytest.mark.parametrize("narrow", [False, True])
def test_hist8_and_cmpex3_kernels_match_ref(narrow):
    dev = _card()
    x = torch.from_numpy(_rows(np.random.default_rng(22), 3 * 2048,
                               narrow)).to(dev)
    got = _launched_once("hist8", RC.hist8, x)
    assert torch.equal(got, RC.hist8_ref(x))
    assert int(got.sum()) == x.numel()
    got = _launched_once("cmpex3", RC.cmpex3, x)
    assert torch.equal(got, RC.cmpex3_ref(x))


@pytest.mark.parametrize("tiles", [1, 2, 20])
def test_hist8_kernel_edges(tiles):
    """One digit filling each tile, negative words, every digit once a
    lane and seeded words, on the plan's grid."""
    dev = _card()
    for kind, v in H8.edge_inputs(tiles).items():
        x = torch.from_numpy(v.astype(np.int32)).to(dev)
        got = _launched_once("hist8", RC.hist8, x)
        assert torch.equal(got, RC.hist8_ref(x)), kind
        assert int(got.sum()) == x.numel()


def test_run_copy_kernel_matches_ref():
    dev = _card()
    rng = np.random.default_rng(23)
    x = torch.from_numpy(_rows(rng, 4096)).to(dev)
    offs = torch.from_numpy(rng.integers(0, 4096 - 16, size=(300,),
                                         dtype=np.int32)).to(dev)
    got = _launched_once("run_copy", RC.run_copy, x, torch.zeros_like(x),
                         offs, 16)
    assert torch.equal(got, RC.run_copy_ref(x, torch.zeros_like(x), offs,
                                            16))
