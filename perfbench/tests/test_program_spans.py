"""The per-layer metrics that read the program's own spans and counters
(program_spans.py; the entries' `stats` dict): reported by the tiny
cells' traced runs on the CPU, left out where the program records
nothing, and the idle split by exact interval overlap on a synthetic
device trace.

Run: python -m pytest perfbench/tests -q."""

import json
import os
import sys

import pytest

import harness
import program_spans as P
from devtrace import DeviceTrace
from test_perfbench_harness import _run, tiny_root  # noqa: F401

COMPRESS_NEW = ["dict_probe_share.compress", "greedy_walk_share.compress",
                "invert_extend_share.compress", "call_setup_share.compress"]
DECODE_NEW = ["python_walk_share.serving", "native_walk_share.serving"]
IDLE = ["idle_unnamed_share.compress", "idle_unnamed_share.serving",
        "idle_unnamed_share.decode"]
ROOT_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "BENCHMARK.json")


def _reader(name):
    return harness.load_reader(os.path.dirname(os.path.abspath(
        harness.__file__)), "layers", name)


def _ctx(counters, window_s=10.0, device=None, calls=()):
    requests = [harness.Request(a, b, 1, 1, True) for a, b in calls]
    return harness.Ctx(counters=counters, window_s=window_s, device=device,
                       requests=requests)


def test_new_metrics_are_declared_with_their_cells():
    b = json.load(open(ROOT_FILE))
    per = {m["name"]: m for m in b["per_layer"]}
    for name in COMPRESS_NEW + DECODE_NEW + IDLE:
        m = per[name]
        assert m["workloads"] and set(m) == {
            "name", "unit", "better", "source", "layer", "moves",
            "workloads"}
        for cell in m["workloads"]:
            assert m["moves"] in [e["name"] for e in
                                  harness.Cell(os.path.dirname(ROOT_FILE),
                                               cell).end_to_end()]
    assert per["native_walk_share.serving"]["better"] == "higher"
    assert per["native_walk_share.serving"]["source"] == "program_counter"
    assert {per[n]["source"] for n in IDLE} == {"device_trace"}


def test_traced_tiny_compress_cell_reports_the_host_parse_split(tiny_root):
    r = _run(tiny_root, "gpu_q5.tiny", trace=True)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(COMPRESS_NEW) <= set(m)
    assert "idle_unnamed_share.compress" not in m   # no card here
    for k in COMPRESS_NEW:
        assert 0 <= m[k] <= 100, k
    parts = (m["dict_probe_share.compress"] + m["greedy_walk_share.compress"]
             + m["invert_extend_share.compress"])
    # the program's steps lie inside the wrapped _host_parse
    assert 0 < parts <= m["host_parse_share.compress"] + 1e-9
    assert m["call_setup_share.compress"] > 0


def test_traced_tiny_decode_cell_reports_the_walk_metrics(tiny_root):
    r = _run(tiny_root, "batch_decode.tiny", trace=True)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(DECODE_NEW) <= set(m)
    assert "idle_unnamed_share.serving" not in m
    assert 0 <= m["python_walk_share.serving"] <= (
        m["host_leg_share.serving"] + 1e-9)
    assert 0 <= m["native_walk_share.serving"] <= 100


def test_untraced_run_passes_no_stats(tiny_root):
    r = _run(tiny_root, "batch_decode.tiny")
    assert not set(DECODE_NEW + COMPRESS_NEW + IDLE) & set(r["metrics"])


def test_a_program_without_spans_leaves_the_new_metrics_out(tiny_root,
                                                            monkeypatch):
    """An entry without `stats=` (the decoder before it had one), and a
    `stats` without spans (compress_gpu before it had them): each new
    metric is left out, the others are reported."""
    from brotli_tpu_torch.decode import batch_gpu
    root, base = tiny_root
    mod = type(sys)("pb_entry_without_stats")

    def decode(streams, max_rounds=8, device=None):
        return batch_gpu.decompress_batch_gpu(streams, max_rounds, device)
    mod.decode = decode
    monkeypatch.setitem(sys.modules, "pb_entry_without_stats", mod)
    cfg_path = os.path.join(base, "configs", "batch_decode.json")
    cfg = json.load(open(cfg_path))
    cfg["entry"] = "pb_entry_without_stats:decode"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    r = _run(tiny_root, "batch_decode.tiny", trace=True)
    assert r["correct"] is True
    assert not set(DECODE_NEW) & set(r["metrics"])
    assert "host_leg_share.serving" in r["metrics"]
    for name in COMPRESS_NEW + DECODE_NEW + IDLE:
        assert _reader(name).read(_ctx([{"device_wait_s": 0.1}])) is None
        assert _reader(name).read(_ctx([])) is None


def _stats(*spans, **counts):
    return dict(counts, spans=[(n, p, int(a * 1e9), int(b * 1e9))
                               for n, p, a, b in spans])


def test_span_readers_take_unions_over_the_window():
    c = [_stats(("compress_gpu", -1, 1.0, 5.0),
                ("host_parse", 0, 1.0, 4.0),
                ("host_parse.dict_probe", 1, 1.0, 2.0),
                ("host_parse.walk", 1, 2.0, 2.5),
                ("host_parse.invert", 1, 2.5, 3.0),
                ("host_parse.extend", 1, 3.0, 3.5),
                ("entry.call_setup", 0, 4.0, 4.5)),
         _stats(("compress_gpu", -1, 6.0, 7.0),
                ("host_parse", 0, 6.0, 7.0),
                ("host_parse.dict_probe", 1, 6.0, 7.0))]
    ctx = _ctx(c, window_s=10.0)
    got = {n: _reader(n).read(ctx) for n in COMPRESS_NEW}
    assert got == pytest.approx({"dict_probe_share.compress": 20.0,
                                 "greedy_walk_share.compress": 5.0,
                                 "invert_extend_share.compress": 10.0,
                                 "call_setup_share.compress": 5.0})
    d = [_stats(("decompress_batch_gpu", -1, 0.0, 4.0),
                ("walk.python", 0, 0.0, 1.0), ("walk.resume", 0, 2.0, 2.5),
                walks_native=3, walks_python=1, walks_resumed=2)] * 2
    ctx = _ctx(d, window_s=5.0)
    # the same call twice: the union counts its time once, the counters
    # twice (6 of 12)
    assert _reader("python_walk_share.serving").read(ctx) == \
        pytest.approx(30.0)
    assert _reader("native_walk_share.serving").read(ctx) == \
        pytest.approx(50.0)
    zero = _ctx([_stats(("decompress_batch_gpu", -1, 0.0, 1.0),
                        walks_native=0, walks_python=0, walks_resumed=0)])
    assert _reader("native_walk_share.serving").read(zero) is None


def test_own_intervals_less_children():
    spans = _stats(("root", -1, 0.0, 10.0), ("a", 0, 1.0, 5.0),
                   ("a.x", 1, 2.0, 3.0), ("a.y", 1, 3.5, 4.0),
                   ("b", 0, 6.0, 7.0))["spans"]
    own = P.own_intervals(spans)
    assert [(n, pytest.approx(a), pytest.approx(b)) for n, a, b in own] == [
        ("a", 1.0, 2.0), ("a", 3.0, 3.5), ("a", 4.0, 5.0),
        ("a.x", 2.0, 3.0), ("a.y", 3.5, 4.0), ("b", 6.0, 7.0)]


def _trace(events_host, t0=0.0, t1=20.0):
    """A device trace whose clock is the host's (trace ns = host s x
    1e9) with `events_host` as (start, end) in host seconds."""
    ev = [("k", int(a * 1e9), int(b * 1e9)) for a, b in events_host]
    return DeviceTrace(ev, int(t0 * 1e9), int(t1 * 1e9), 0, 0.0)


def test_idle_split_by_overlap_not_by_midpoint(capsys):
    """One idle gap, 2-9 s, runs through the entry's own code (2-3, 5-6,
    8-9), span a (3-5) and span b (6-8): it is split among the three,
    not given whole to the span open at its midpoint (b)."""
    st = _stats(("compress_gpu", -1, 1.0, 10.0), ("a", 0, 3.0, 5.0),
                ("b", 0, 6.0, 8.0))
    dt = _trace([(0.5, 2.0), (9.0, 10.5)])
    split = P.idle_split([(dt.to_host(a), dt.to_host(b))
                          for a, b in dt.idle_gaps()], [(1.0, 10.0)], [st])
    assert split == pytest.approx({"a": 2.0, "b": 2.0, P.UNNAMED: 3.0})
    ctx = _ctx([st], window_s=20.0, device=dt, calls=[(1.0, 10.0)])
    assert _reader("idle_unnamed_share.compress").read(ctx) == \
        pytest.approx(15.0)
    assert "idle_unnamed_share: device idle" in capsys.readouterr().err


def test_idle_split_nested_spans_and_outside_the_root():
    """Idle time goes to the innermost span; a call's time outside its
    root span and idle time between calls are apart: the first is the
    entry's own, the second in no call."""
    st = _stats(("decompress_batch_gpu", -1, 1.5, 9.5),
                ("round.kernel", 0, 2.0, 6.0), ("walk.resume", 1, 3.0, 4.0))
    dt = _trace([(4.0, 5.0)], 0.0, 12.0)
    idle = [(dt.to_host(a), dt.to_host(b)) for a, b in dt.idle_gaps()]
    split = P.idle_split(idle, [(1.0, 10.0)], [st])
    # idle in the call: 1-4 and 5-10; round.kernel own 2-3 and 5-6,
    # walk.resume 3-4, the rest (1-2, 6-10) unnamed
    assert split == pytest.approx({"round.kernel": 2.0, "walk.resume": 1.0,
                                   P.UNNAMED: 5.0})
    ctx = _ctx([st], window_s=12.0, device=dt, calls=[(1.0, 10.0)])
    assert _reader("idle_unnamed_share.decode").read(ctx) == \
        pytest.approx(500.0 / 12.0)


def test_idle_unnamed_zero_where_the_device_is_busy():
    st = _stats(("compress_gpu", -1, 1.0, 3.0))
    ctx = _ctx([st], window_s=4.0, device=_trace([(0.0, 4.0)], 0.0, 4.0),
               calls=[(1.0, 3.0)])
    assert _reader("idle_unnamed_share.compress").read(ctx) == 0.0
    ctx = _ctx([st], window_s=4.0, device=None, calls=[(1.0, 3.0)])
    assert _reader("idle_unnamed_share.compress").read(ctx) is None
