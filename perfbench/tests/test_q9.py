"""The q9 deployment: configuration gpu_q9 and cell gpu_q9.bulk as
declared, its nine per-layer readers exact on known spans, counters and
launches and silent where the program records nothing (the parent's
compress_gpu has no match counters), a tiny gpu_q9 cell on the CPU
(correct, traced, and not correct under the control and the faults),
and the q9 matcher held to plain_match9.py on the card at the cell's
sizes (on the CPU: tests/test_torch_plain_match9.py).

Run: python -m pytest perfbench/tests -q  (on the card: -m cuda -s)."""

import json
import os
import shutil

import pytest

import card_match9
import harness
import reference
from devtrace import DeviceTrace
from rooflines.fold import fold_bytes, fold_ops
from rooflines.peaks import bound_s
from spans import Span
from traffic import Files
from test_maxdev import TINY_FILES, _Wraps
from test_program_spans import ROOT_FILE, _ctx, _reader, _stats

BENCH_DIR = os.path.dirname(os.path.abspath(harness.__file__))
CELL = "gpu_q9.bulk"
TINY_CELL = "gpu_q9.tiny"
HOST_LEG = "host leg: gpu_path._host_parse"
LAYERS = {
    "fold_roofline.q9": ("higher", "device_trace", "kernels",
                         "compress_MBps"),
    "short_fold_roofline.q9": ("higher", "device_trace", "kernels",
                               "compress_MBps"),
    "invert_extend_share.q9": ("lower", "program_span", HOST_LEG,
                               "compress_MBps"),
    "short_win_share.q9": ("higher", "program_counter", HOST_LEG, "ratio"),
    "host_parse_share.q9": ("lower", "program_span", HOST_LEG,
                            "compress_MBps"),
    "store_share.q9": ("lower", "program_span", "serializer",
                       "compress_MBps"),
    "call_setup_share.q9": ("lower", "program_span", "entry",
                            "compress_MBps"),
    "device_idle_share.q9": ("lower", "device_trace", "device",
                             "compress_MBps"),
    "idle_unnamed_share.q9": ("lower", "device_trace", "device",
                              "compress_MBps"),
}
PROGRAM = ["invert_extend_share.q9", "short_win_share.q9",
           "host_parse_share.q9", "store_share.q9", "call_setup_share.q9"]
KIND = "NVIDIA H100 80GB HBM3"
N = 4718592
MAIN, SHORT = (N, 2, 2, 16, 8), (N, 1, 1, 16, 0)


# -- what is declared ---------------------------------------------------------


def test_configuration_and_cell_declared():
    b = json.load(open(ROOT_FILE))
    cfgs = {c["name"]: c for c in b["configs"]}
    cfg = cfgs["gpu_q9"]
    assert cfg["file"] == "perfbench/configs/gpu_q9.json"
    assert cfg["reduced"] == [] and cfg["source"].endswith(
        "c/enc/quality.h")
    assert cfg["source"] not in {c["source"] for c in b["configs"]
                                 if c is not cfg}
    cell = {w["name"]: w for w in b["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "gpu_q9", "bulk", 1)
    for m in b["end_to_end"]:
        assert (CELL in m.get("workloads", [CELL])) is (
            m["name"] in ("compress_MBps", "ratio", "setup_s")), m["name"]
    f = json.load(open(os.path.join(os.path.dirname(ROOT_FILE),
                                    cfg["file"])))
    assert f["entry"] == "brotli_tpu_torch:compress_gpu"
    assert f["kwargs"] == {"quality": 9, "lgwin": 22, "mode": 0}
    assert f["request"] == "compress" and f["reduced"] == []
    assert f["source"] == cfg["source"]
    assert "plain_match9.py" in f["reference"]
    assert {"quality", "data", "lgwin"} <= set(f["assumed"])


def test_per_layer_metrics_declared_with_the_cell():
    b = json.load(open(ROOT_FILE))
    per = {m["name"]: m for m in b["per_layer"]}
    layers = {name: m["layer"] for name, m in per.items()}
    for name in LAYERS:
        m = per[name]
        better, source, layer, moves = LAYERS[name]
        assert (m["better"], m["source"], m["moves"], m["unit"]) == (
            better, source, moves, "%")
        assert m["layer"].startswith(layer) and m["workloads"] == [CELL]
        twin = m["name"].split(".")[0] + ".compress"
        if twin in layers:     # the layer as the default path names it
            assert m["layer"] == layers[twin], m["name"]
    names = [m["name"] for m in harness.Cell(
        os.path.dirname(ROOT_FILE), CELL).per_layer()]
    assert names == list(LAYERS)
    for name in LAYERS:        # each has a reader, the idle ones shared
        assert _reader(name).read


# -- the readers on known spans, counters and launches ------------------------


def test_span_readers_exact():
    calls = [_stats(("compress_gpu", -1, 1.0, 5.0),
                    ("entry.call_setup", 0, 1.0, 1.5),
                    ("host_parse", 0, 2.0, 4.0),
                    ("host_parse.invert", 2, 2.0, 3.0),
                    ("host_parse.extend", 2, 3.0, 3.25))]
    ctx = _ctx(calls, window_s=10.0)
    assert _reader("invert_extend_share.q9").read(ctx) == \
        pytest.approx(12.5)
    assert _reader("call_setup_share.q9").read(ctx) == pytest.approx(5.0)
    for name in ("invert_extend_share.q9", "call_setup_share.q9"):
        assert _reader(name).read(_ctx([])) is None


def test_wrapper_readers_are_the_compress_readers():
    t = [Span(0.0, 1.0, None), Span(0.5, 2.0, None)]
    for name in ("store_share", "host_parse_share"):
        theirs = _reader(name + ".compress")
        mine = _reader(name + ".q9")
        spans = {p: t for p in theirs.WRAPS}
        ctx = harness.Ctx(wraps=_Wraps(spans), window_s=8.0)
        assert mine.WRAPS == theirs.WRAPS
        assert mine.read(ctx) == theirs.read(ctx) == pytest.approx(25.0)


def test_short_win_reads_exact_counts_and_is_silent_on_the_parent():
    calls = [_stats(("compress_gpu", -1, 0.0, 1.0), **{
        "match.positions": 800, "match.short_won": 100}),
        _stats(("compress_gpu", -1, 1.0, 2.0), **{
            "match.positions": 200, "match.short_won": 50})]
    r = _reader("short_win_share.q9")
    assert r.read(_ctx(calls)) == pytest.approx(15.0)
    zero = _stats(("compress_gpu", -1, 0.0, 1.0), **{
        "match.positions": 0, "match.short_won": 0})
    assert r.read(_ctx([zero])) is None
    # the parent's compress_gpu: spans and the other counters, none of
    # these
    parent = _stats(("compress_gpu", -1, 0.0, 1.0), **{
        "dict.positions": 10, "dict.won": 1, "parse.positions": 0,
        "parse.copied": 0})
    assert r.read(_ctx([parent])) is None
    assert r.read(_ctx([])) is None


def _launches(shapes, times):
    """A context with `shapes` recorded for both roofline readers and
    fold kernels of the given lengths (in units of each shape's bound)
    traced in order."""
    mine = [_reader("fold_roofline.q9"), _reader("short_fold_roofline.q9")]
    ev, t = [], 0
    for (n, n_keys, n_pay, k_fwd, k_back), k in zip(shapes, times):
        b = bound_s(fold_bytes(n, n_keys, n_pay),
                    fold_ops(n, n_keys, k_fwd, k_back), KIND)[0]
        ev.append(("fold_kernel<...>", t, t + int(k * b * 1e9)))
        t += 10 ** 9
    dt = DeviceTrace(ev, 0, t + 1, 0, 0.0)
    spans = {mine[0].WRAPS[0][0]: [
        Span(0.0, 1.0, {r.__name__: s for r in mine}) for s in shapes]}
    ctx = harness.Ctx(wraps=_Wraps(spans), device=dt, kind=KIND,
                      window_s=2.0)
    return mine, ctx


def test_fold_rooflines_read_their_forms():
    """Main and short launches in turns, as a q9 span launches them: each
    metric is the median share of its form's pairs; a launch of a third
    form, or a launch without its kernel: nothing."""
    shapes = [MAIN, SHORT, MAIN, SHORT, MAIN, SHORT]
    (main, short), ctx = _launches(shapes, [4, 2, 5, 2, 6, 10])
    assert main.read(ctx) == pytest.approx(20.0, rel=1e-3)   # 1/5
    assert short.read(ctx) == pytest.approx(50.0, rel=1e-3)  # 1/2
    q5 = (N, 1, 1, 32, 0)
    (main, short), ctx = _launches([MAIN, SHORT, q5], [4, 2, 2])
    assert main.read(ctx) is None and short.read(ctx) is None
    (main, short), ctx = _launches([MAIN, SHORT], [4, 2])
    ctx.device.events.append(("fold_kernel<...>", 5 * 10 ** 9,
                              5 * 10 ** 9 + 10 ** 5))
    assert main.read(ctx) is None and short.read(ctx) is None
    assert main.read(harness.Ctx(wraps=_Wraps({}), device=None)) is None


# -- a tiny gpu_q9 cell on the CPU ------------------------------------------


@pytest.fixture
def q9_root(tmp_path):
    """A checkout whose BENCHMARK.json holds one tiny gpu_q9 cell (a new
    traffic mix), with every metric of gpu_q9.bulk, beside a copy of
    the harness."""
    base = tmp_path / "pb"
    shutil.copytree(BENCH_DIR, base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (base / "traffic" / "tinyfiles.json").write_text(json.dumps(TINY_FILES))
    b = json.load(open(ROOT_FILE))
    b["workloads"] = [{"name": TINY_CELL, "config": "gpu_q9",
                       "traffic": "tinyfiles", "chips": 1, "why": "test"}]
    for c in b["configs"]:
        c["file"] = "pb/configs/%s.json" % c["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [TINY_CELL] if CELL in m["workloads"] else []
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return str(tmp_path), str(base)


def _run(root, **kw):
    root, base = root
    return harness.run(root, TINY_CELL, kw.pop("seed", 2 ** 31 + 31), 1.0,
                       kw.pop("trace", False), device="cpu", base=base,
                       **kw)


def test_tiny_cell_correct_and_traced(q9_root):
    r = _run(q9_root)
    assert r["correct"] is True and r["failed"] == 0
    assert {"compress_MBps", "ratio", "setup_s"} == set(r["metrics"])
    r = _run(q9_root, trace=True)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == set(PROGRAM)       # no card: no device metric
    for k in PROGRAM:
        assert 0 <= m[k] < 100, k
    assert 0 < m["short_win_share.q9"]
    assert 0 < m["invert_extend_share.q9"] <= m["host_parse_share.q9"]


@pytest.mark.parametrize("fault", ["control", "alter", "unchanged", "half"])
def test_tiny_cell_control_and_faults_not_correct(q9_root, fault):
    r = _run(q9_root, fault=fault, seed=5)
    assert r["correct"] is False
    assert r["checks"]["bad_streams"]["value"] > 0


# -- the q9 matcher against the plain reference -------------------------------


@pytest.mark.cuda
def test_card_matcher_on_the_bulk_files(cuda_card):
    """Every span of the 8 bulk files of one seed: the card's (len, dist)
    after the host's merge and extension equal the plain reference's at
    every real position, the program's count of the short fold's wins
    equals the reference's, every stream decodes; the first file's card
    stream equals its CPU stream."""
    from brotli_tpu_torch import compress_gpu
    seed = 4920000001
    traffic = json.load(open(os.path.join(BENCH_DIR, "traffic",
                                          "bulk.json")))
    pool = Files(traffic, seed)
    cfg = json.load(open(os.path.join(BENCH_DIR, "configs",
                                      "gpu_q9.json")))
    kw = {k: v for k, v in cfg["kwargs"].items() if k != "quality"}
    total = {}
    streams = []
    for f in pool.pool:
        s, fig = card_match9.checked_compress(f, **kw)
        streams.append(s)
        for k, v in fig.items():
            total[k] = max(total.get(k, 0), v) if k == "max_dist" else \
                total.get(k, 0) + v
    assert total["spans"] == 8 * len(pool.pool)
    assert reference.bad_streams(list(zip(streams, pool.pool))) == 0
    cpu = compress_gpu(pool.pool[0], **cfg["kwargs"], device="cpu")
    assert cpu == streams[0]
    print(f"gpu_q9 bulk check: seed {seed}, {pool.sha256()}, "
          f"{json.dumps(total)}, short-fold wins "
          f"{100 * total['short'] / total['positions']:.4f}%, ratio "
          f"{sum(map(len, pool.pool)) / sum(map(len, streams)):.4f}; "
          f"card == cpu on file 0 ({len(cpu)} bytes)")
