"""split_plan_share.compress and split_plan_share.maxdev: declared
last, on the compress cells, in the serializer's layer; the union of
the program's split.hysteresis and split.merge spans, exact on known
spans and silent where the program records none (the parent's
compress_gpu has store.split and no split.* span); reported by a traced
tiny max_device cell on the CPU.

Run: python -m pytest perfbench/tests -q."""

import json

import pytest

from test_maxdev import _run, maxdev_root  # noqa: F401
from test_program_spans import ROOT_FILE, _ctx, _reader, _stats

METRICS = {"split_plan_share.compress": ["gpu_q5.bulk", "gpu_q5.web"],
           "split_plan_share.maxdev": ["maxdev_q5.bulk"]}


def test_declared_last_in_the_serializer_layer():
    b = json.load(open(ROOT_FILE))
    per = {m["name"]: m for m in b["per_layer"]}
    assert [m["name"] for m in b["per_layer"][-2:]] == list(METRICS)
    for name, cells in METRICS.items():
        m = per[name]
        assert m == {"name": name, "unit": "%", "better": "lower",
                     "source": "program_span",
                     "layer": per["store_share.compress"]["layer"],
                     "moves": "compress_MBps", "workloads": cells}
        e2e = {e["name"]: e for e in b["end_to_end"]}["compress_MBps"]
        assert set(cells) <= set(e2e["workloads"])


def test_union_of_the_plan_spans_and_silent_without_them():
    calls = [_stats(("compress_gpu", -1, 0.0, 6.0),
                    ("store.split", 0, 1.0, 4.0),
                    ("split.device", 1, 1.0, 2.0),
                    ("split.hysteresis", 1, 2.0, 2.5),
                    ("split.merge", 1, 2.5, 3.5),
                    ("store.split", 0, 4.0, 5.0)),
             _stats(("compress_gpu", -1, 6.0, 8.0),
                    ("store.split", 0, 6.0, 7.0),
                    ("split.device", 1, 6.0, 6.5),
                    ("split.hysteresis", 1, 6.5, 6.75),
                    ("split.merge", 1, 6.75, 7.0))]
    parent = [_stats(("compress_gpu", -1, 0.0, 2.0),
                     ("store.split", 0, 0.5, 1.5))]
    for name in METRICS:
        r = _reader(name)
        assert r.read(_ctx(calls, window_s=10.0)) == pytest.approx(20.0)
        assert r.read(_ctx(calls * 2, window_s=10.0)) == pytest.approx(
            20.0)                         # a span counted once
        assert r.read(_ctx(parent)) is None
        assert r.read(_ctx([])) is None
        assert r.read(_ctx([{"device_wait_s": 0.1}])) is None
        assert r.COUNTERS == "stats"


def test_traced_tiny_max_device_cell_reports_it(maxdev_root):  # noqa: F811
    r = _run(maxdev_root, trace=True)
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0 < m["split_plan_share.maxdev"] < m["store_share.maxdev"]
    assert "split_plan_share.compress" not in m
