"""The max_device deployment: configuration maxdev_q5 and cell
maxdev_q5.bulk as declared, its seven per-layer readers exact on known
spans, counters and launches and silent where the program records
nothing (the parent's compress_gpu has no pipe.parse span and no parse
counters), a tiny maxdev_q5 cell on the CPU (correct, traced, and not
correct under the control and the faults), and the device parse held to
plain_parse.py on the card at the cell's sizes (on the CPU:
tests/test_torch_plain_parse.py).

Run: python -m pytest perfbench/tests -q  (on the card: -m cuda -s)."""

import json
import os
import shutil

import pytest

import card_parse
import harness
import reference
from devtrace import DeviceTrace
from rooflines.fold import fold_bytes, fold_ops
from rooflines.peaks import bound_s
from spans import Span
from traffic import Files
from test_program_spans import ROOT_FILE, _ctx, _reader, _stats

BENCH_DIR = os.path.dirname(os.path.abspath(harness.__file__))
CELL = "maxdev_q5.bulk"
TINY_CELL = "maxdev_q5.tiny"
LAYERS = {
    "parse_enqueue_share.maxdev": ("lower", "program_span",
                                   "device parse", "compress_MBps"),
    "commands_share.maxdev": ("lower", "program_span", "command assembly",
                              "compress_MBps"),
    "store_share.maxdev": ("lower", "program_span", "serializer",
                           "compress_MBps"),
    "fold_roofline.maxdev": ("higher", "device_trace", "kernels",
                             "compress_MBps"),
    "device_idle_share.maxdev": ("lower", "device_trace", "device",
                                 "compress_MBps"),
    "idle_unnamed_share.maxdev": ("lower", "device_trace", "device",
                                  "compress_MBps"),
    "copy_cover_share.maxdev": ("higher", "program_counter", "device parse",
                                "ratio"),
}
PROGRAM = ["parse_enqueue_share.maxdev", "commands_share.maxdev",
           "store_share.maxdev", "copy_cover_share.maxdev"]
TINY_FILES = {"kind": "files",
              "sizes": {"dist": "log_uniform", "min": 2000, "max": 9000,
                        "count": 8},
              "mix": {"source": 1, "zipf": 1, "records": 1, "ints": 1,
                      "random": 1},
              "strata": 4}


# -- what is declared -----------------------------------------------------------


def test_configuration_and_cell_declared():
    b = json.load(open(ROOT_FILE))
    cfg = {c["name"]: c for c in b["configs"]}["maxdev_q5"]
    assert cfg["file"] == "perfbench/configs/maxdev_q5.json"
    assert cfg["reduced"] == [] and cfg["source"].endswith("1606.00519")
    gpu_q5 = {c["name"]: c for c in b["configs"]}["gpu_q5"]
    assert (cfg["source"], cfg["reduced"]) != (gpu_q5["source"],
                                               gpu_q5["reduced"])
    cell = {w["name"]: w for w in b["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "maxdev_q5", "bulk", 1)
    assert b["workloads"][-1] == cell and b["configs"][-1] == cfg
    for m in b["end_to_end"]:
        assert (CELL in m.get("workloads", [CELL])) is (
            m["name"] in ("compress_MBps", "ratio", "setup_s")), m["name"]
    f = json.load(open(os.path.join(os.path.dirname(ROOT_FILE),
                                    cfg["file"])))
    assert f["entry"] == "brotli_tpu_torch:compress_gpu"
    assert f["kwargs"] == {"quality": 5, "lgwin": 22, "mode": 0,
                           "max_device": True}
    assert f["request"] == "compress" and f["reduced"] == []
    assert f["source"] == cfg["source"]
    assert {"max_device", "quality", "data"} <= set(f["assumed"])


def test_per_layer_metrics_declared_last_with_the_cell():
    b = json.load(open(ROOT_FILE))
    per = b["per_layer"]
    assert [m["name"] for m in per[-len(LAYERS):]] == list(LAYERS)
    for m in per[-len(LAYERS):]:
        better, source, layer, moves = LAYERS[m["name"]]
        assert (m["better"], m["source"], m["moves"], m["unit"]) == (
            better, source, moves, "%")
        assert m["layer"].startswith(layer) and m["workloads"] == [CELL]
    names = [m["name"] for m in harness.Cell(
        os.path.dirname(ROOT_FILE), CELL).per_layer()]
    assert names == list(LAYERS)


# -- the readers on known spans, counters and launches ----------------------------


def test_span_readers_exact_and_silent_without_the_spans():
    calls = [_stats(("compress_gpu", -1, 1.0, 5.0),
                    ("pipe.dispatch", 0, 1.0, 2.0),
                    ("pipe.parse", 1, 1.5, 1.75),
                    ("host_parse", 0, 2.0, 3.0),
                    ("host_parse.commands", 3, 2.0, 2.5)),
             _stats(("compress_gpu", -1, 6.0, 7.0),
                    ("pipe.dispatch", 0, 6.0, 6.5),
                    ("pipe.parse", 1, 6.0, 6.25),
                    ("host_parse", 0, 6.5, 7.0),
                    ("host_parse.commands", 3, 6.5, 7.0))]
    ctx = _ctx(calls, window_s=10.0)
    assert _reader("parse_enqueue_share.maxdev").read(ctx) == \
        pytest.approx(5.0)
    assert _reader("commands_share.maxdev").read(ctx) == pytest.approx(10.0)
    # the parent's compress_gpu: spans, none of these two
    parent = _ctx([_stats(("compress_gpu", -1, 0.0, 1.0),
                          ("host_parse", 0, 0.2, 0.5))])
    for name in PROGRAM:
        if name != "store_share.maxdev":
            assert _reader(name).read(parent) is None, name
            assert _reader(name).read(_ctx([])) is None, name


def test_copy_cover_reads_exact_counts():
    calls = [_stats(("compress_gpu", -1, 0.0, 1.0), **{
        "parse.positions": 800, "parse.copied": 600}),
        _stats(("compress_gpu", -1, 1.0, 2.0), **{
            "parse.positions": 200, "parse.copied": 50})]
    r = _reader("copy_cover_share.maxdev")
    assert r.read(_ctx(calls)) == pytest.approx(65.0)
    zero = _stats(("compress_gpu", -1, 0.0, 1.0), **{
        "parse.positions": 0, "parse.copied": 0})
    assert r.read(_ctx([zero])) is None
    assert r.read(_ctx([_stats(("compress_gpu", -1, 0.0, 1.0), **{
        "dict.positions": 10, "dict.won": 1})])) is None
    assert r.read(_ctx([{"device_wait_s": 0.1}])) is None


class _Wraps:
    def __init__(self, spans):
        self.spans = spans


def test_store_share_is_the_compress_reader():
    t = [Span(0.0, 1.0, None), Span(0.5, 2.0, None)]
    spans = {p: t for p in _reader("store_share.compress").WRAPS}
    ctx = harness.Ctx(wraps=_Wraps(spans), window_s=8.0)
    mine, theirs = (_reader("store_share.maxdev"),
                    _reader("store_share.compress"))
    assert mine.WRAPS == theirs.WRAPS
    assert mine.read(ctx) == theirs.read(ctx) == pytest.approx(25.0)


def test_fold_roofline_reads_the_max_device_launches():
    """Two launches of the 5-payload fold recorded under this metric's
    name, two fold kernels traced: the median share of the bound; a
    launch of another form recorded: nothing."""
    r = _reader("fold_roofline.maxdev")
    kind = "NVIDIA H100 80GB HBM3"
    n = 4718592
    shape = (n, 1, 5, 32, 0)
    bound = bound_s(fold_bytes(n, 1, 5), fold_ops(n, 1, 32, 0), kind)[0]
    ev = [("fold_kernel<1, 5, 0, 0>", 0, int(4 * bound * 1e9)),
          ("fold_kernel<1, 5, 0, 0>", 10 ** 9, 10 ** 9 + int(
              5 * bound * 1e9))]
    dt = DeviceTrace(ev, 0, 2 * 10 ** 9, 0, 0.0)

    def ctx(shapes):
        spans = {r.WRAPS[0][0]: [Span(0.0, 1.0, {r.__name__: s})
                                 for s in shapes]}
        return harness.Ctx(wraps=_Wraps(spans), device=dt, kind=kind,
                           window_s=2.0)
    assert r.read(ctx([shape, shape])) == pytest.approx(22.5, rel=1e-3)
    assert r.read(ctx([shape, (n, 1, 1, 32, 0)])) is None
    assert r.read(ctx([shape])) is None       # one launch, two kernels
    assert r.read(harness.Ctx(wraps=_Wraps({}), device=None)) is None


# -- a tiny maxdev_q5 cell on the CPU ------------------------------------------


@pytest.fixture
def maxdev_root(tmp_path):
    """A checkout whose BENCHMARK.json holds one tiny maxdev_q5 cell (a
    new traffic mix), with every metric of maxdev_q5.bulk, beside a
    copy of the harness."""
    base = tmp_path / "pb"
    shutil.copytree(BENCH_DIR, base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (base / "traffic" / "tinyfiles.json").write_text(json.dumps(TINY_FILES))
    b = json.load(open(ROOT_FILE))
    b["workloads"] = [{"name": TINY_CELL, "config": "maxdev_q5",
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
    return harness.run(root, TINY_CELL, kw.pop("seed", 2 ** 31 + 29), 1.0,
                       kw.pop("trace", False), device="cpu", base=base,
                       **kw)


def test_tiny_cell_correct_and_traced(maxdev_root):
    r = _run(maxdev_root)
    assert r["correct"] is True and r["failed"] == 0
    assert {"compress_MBps", "ratio", "setup_s"} == set(r["metrics"])
    r = _run(maxdev_root, trace=True)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(m) == set(PROGRAM)       # no card: no device metric
    assert 0 < m["copy_cover_share.maxdev"] < 100
    for k in PROGRAM:
        assert 0 <= m[k] < 100, k
    assert m["commands_share.maxdev"] > 0


@pytest.mark.parametrize("fault", ["control", "alter", "unchanged", "half"])
def test_tiny_cell_control_and_faults_not_correct(maxdev_root, fault):
    r = _run(maxdev_root, fault=fault, seed=5)
    assert r["correct"] is False
    assert r["checks"]["bad_streams"]["value"] > 0


# -- the device parse against the plain walk ------------------------------------


@pytest.mark.cuda
def test_card_parse_on_the_bulk_files(cuda_card):
    """Every span of the 8 bulk files of one seed: the card's commands
    equal the plain walk's over the card's fold outputs, every stream
    decodes; the first file's card stream equals its CPU stream."""
    from brotli_tpu_torch import compress_gpu
    seed = 4920000001
    traffic = json.load(open(os.path.join(BENCH_DIR, "traffic",
                                          "bulk.json")))
    pool = Files(traffic, seed)
    cfg = json.load(open(os.path.join(BENCH_DIR, "configs",
                                      "maxdev_q5.json")))
    kw = {k: v for k, v in cfg["kwargs"].items() if k != "max_device"}
    total = dict(spans=0, commands=0, positions=0, copied=0)
    streams = []
    for f in pool.pool:
        s, fig = card_parse.checked_compress(f, **kw)
        streams.append(s)
        for k in total:
            total[k] += fig[k]
    assert total["spans"] == 8 * len(pool.pool)
    assert reference.bad_streams(list(zip(streams, pool.pool))) == 0
    cpu = compress_gpu(pool.pool[0], **kw, max_device=True, device="cpu")
    assert cpu == streams[0]
    print(f"maxdev_q5 bulk check: seed {seed}, {pool.sha256()}, "
          f"{json.dumps(total)}, copy cover "
          f"{100 * total['copied'] / total['positions']:.4f}%, ratio "
          f"{sum(map(len, pool.pool)) / sum(map(len, streams)):.4f}; "
          f"card == cpu on file 0 ({len(cpu)} bytes)")
