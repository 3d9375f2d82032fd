"""dict_win_share.compress, the share of the probed positions that the
static dictionary won (the program's counters dict.won and
dict.positions): declared with its cells, reported by the tiny compress
cell's traced run on the CPU, left out of the untraced run and where
the program counts nothing, and exact on known counters.

Run: python -m pytest perfbench/tests -q."""

import json

import pytest

from test_perfbench_harness import _run, tiny_root  # noqa: F401
from test_program_spans import ROOT_FILE, _ctx, _reader, _stats

NAME = "dict_win_share.compress"


def test_declared_with_its_cells():
    b = json.load(open(ROOT_FILE))
    m = {m["name"]: m for m in b["per_layer"]}[NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_counter",
                 "layer": "host leg: gpu_path._host_parse",
                 "moves": "ratio",
                 "workloads": ["gpu_q5.bulk", "gpu_q5.web"]}
    assert b["per_layer"][-1]["name"] == NAME


def test_traced_tiny_compress_cell_reports_it(tiny_root):
    r = _run(tiny_root, "gpu_q5.tiny", trace=True)
    assert r["correct"] is True
    assert 0 <= r["metrics"][NAME]["value"] <= 100


def test_untraced_run_leaves_it_out(tiny_root):
    r = _run(tiny_root, "gpu_q5.tiny")
    assert NAME not in r["metrics"]


def test_reader_sums_the_counters_over_the_window():
    calls = [_stats(("compress_gpu", -1, 0.0, 1.0), **{
        "dict.positions": 800, "dict.won": 40}),
        _stats(("compress_gpu", -1, 1.0, 2.0), **{
            "dict.positions": 200, "dict.won": 10})]
    assert _reader(NAME).read(_ctx(calls)) == pytest.approx(5.0)
    empty = _stats(("compress_gpu", -1, 0.0, 1.0), **{
        "dict.positions": 0, "dict.won": 0})
    assert _reader(NAME).read(_ctx([empty])) is None


def test_a_program_without_the_counters_leaves_it_out():
    """compress_gpu before it probed on the card returned spans and no
    dictionary counters: nothing to read."""
    spans_only = _stats(("compress_gpu", -1, 0.0, 1.0),
                        ("host_parse.dict_probe", 0, 0.2, 0.5))
    assert _reader(NAME).read(_ctx([spans_only])) is None
    assert _reader(NAME).read(_ctx([{"device_wait_s": 0.1}])) is None
    assert _reader(NAME).read(_ctx([])) is None
