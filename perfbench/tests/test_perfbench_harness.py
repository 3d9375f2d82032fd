"""The benchmark harness on the CPU: generators, lookup by name, the
result line, the refusal without a card, the import rules, the
reference, the roofline counts, the span and trace arithmetic, and the
control and the faults that have to come out as not correct.

Run: python -m pytest perfbench/tests -q  (on the card: -m cuda)."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness
import corpus
import reference
import spans
from devtrace import DeviceTrace, window_of
from rooflines import decode_step, fold, peaks
from traffic import Files, Streams, arrivals

BENCH_DIR = os.path.dirname(os.path.abspath(harness.__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = {"jax", "jaxlib", "flax", "brotli_tpu"}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]

TINY_FILES = {"kind": "files",
              "sizes": {"dist": "log_uniform", "min": 2000, "max": 9000,
                        "count": 8},
              "mix": {"source": 1, "zipf": 1, "records": 1, "ints": 1,
                      "random": 1},
              "strata": 4}
TINY_STREAMS = {"kind": "streams",
                "corpus": {"bytes": 20000,
                           "mix": {"source": 1, "zipf": 1, "records": 1}},
                "streams": {"count": 8, "bytes": 600,
                            "encoders": ["fast_q1", "ref_q3"]},
                "request_streams": 4, "check_every": 2}
TINY_OPEN = dict(TINY_STREAMS, arrivals={"process": "poisson",
                                         "rate_per_s": 6.0, "block": 8})


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout whose BENCHMARK.json holds two new cells that only new
    files define (a traffic mix each), beside a copy of the harness."""
    base = tmp_path / "pb"
    shutil.copytree(BENCH_DIR, base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (base / "traffic" / "tinyfiles.json").write_text(json.dumps(TINY_FILES))
    (base / "traffic" / "tinystreams.json").write_text(
        json.dumps(TINY_STREAMS))
    b = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    (base / "traffic" / "tinyopen.json").write_text(json.dumps(TINY_OPEN))
    # a configuration whose request kind is a new file of kinds/
    shutil.copy(base / "kinds" / "compress.py",
                base / "kinds" / "compress_copy.py")
    cfg = json.loads((base / "configs" / "gpu_q5.json").read_text())
    (base / "configs" / "gpu_copy.json").write_text(
        json.dumps(dict(cfg, request="compress_copy")))
    cells = {"gpu_q5": "gpu_q5.tiny", "batch_decode": "batch_decode.tiny"}
    b["workloads"] = [
        {"name": "gpu_q5.tiny", "config": "gpu_q5", "traffic": "tinyfiles",
         "chips": 1, "why": "test"},
        {"name": "batch_decode.tiny", "config": "batch_decode",
         "traffic": "tinystreams", "chips": 1, "why": "test"},
        {"name": "batch_decode.open", "config": "batch_decode",
         "traffic": "tinyopen", "chips": 1, "why": "test"},
        {"name": "gpu_copy.tiny", "config": "gpu_copy",
         "traffic": "tinyfiles", "chips": 1, "why": "test"}]
    b["configs"].append(dict(b["configs"][0], name="gpu_copy"))
    for c in b["configs"]:
        c["file"] = "pb/configs/%s.json" % c["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            cfg = {w.split(".")[0] for w in m["workloads"]}
            m["workloads"] = [cells[c] for c in sorted(cfg)]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return str(tmp_path), str(base)


def _run(tiny_root, cell, **kw):
    root, base = tiny_root
    kw.setdefault("seconds", 1.0)
    kw.setdefault("trace", False)
    return harness.run(root, cell, kw.pop("seed", 2 ** 31 + 17),
                     kw.pop("seconds"), kw.pop("trace"), device="cpu",
                     base=base, **kw)


# -- generators -------------------------------------------------------------


def test_make_files_deterministic_and_seeded():
    mix = {"source": 2, "zipf": 2, "records": 2, "ints": 1, "random": 1}
    a = corpus.make_files([5000, 70000], 2 ** 40 + 3, mix)
    assert a == corpus.make_files([5000, 70000], 2 ** 40 + 3, mix)
    assert [len(f) for f in a] == [5000, 70000]
    assert a != corpus.make_files([5000, 70000], 2 ** 40 + 4, mix)
    assert corpus.make_files([100], -5, mix) == corpus.make_files(
        [100], -5, mix)
    assert corpus.shares(1000, {"source": 1, "random": 1}) == [
        500, 0, 0, 0, 500]


def test_files_same_sizes_every_seed_in_strata():
    a, b = Files(TINY_FILES, 11), Files(TINY_FILES, 12)
    assert a.sizes == b.sizes and a.pool != b.pool
    oa, ob = a.order(), Files(TINY_FILES, 11).order()
    first = [next(oa) for _ in range(16)]
    assert first == [next(ob) for _ in range(16)]
    per = len(a.pool) // a.strata
    for r in range(0, 16, a.strata):   # each round: one of every stratum
        assert sorted(i // per for i in first[r:r + a.strata]) == list(
            range(a.strata))
    assert [a.sizes[i] for i in a.warm()] == sorted(
        {(s - 1).bit_length(): s for s in reversed(a.sizes)}.values())
    w = Files(dict(TINY_FILES, warm_requests=3), 11).warm()
    assert w[:len(a.warm())] == a.warm() and len(w) == len(a.warm()) + 3


def test_streams_deterministic_balanced():
    enc = {"fast_q1": lambda p: b"F" + p, "ref_q3": lambda p: b"N" + p}
    a = Streams(TINY_STREAMS, 99, enc)
    b = Streams(TINY_STREAMS, 99, enc)
    assert a.sha256() == b.sha256() and a.plain == b.plain
    oa, ob = a.order(), b.order()
    for _ in range(5):
        x = next(oa)
        assert x == next(ob) and len(set(x)) == len(x) == 4
        assert sum(i % 2 for i in x) == 2   # as many of each encoder
    assert a.warm() == b.warm() and len(a.warm()) == 1
    assert Streams(TINY_STREAMS, 100, enc).sha256() != a.sha256()


def test_arrivals_same_gaps_every_seed():
    assert arrivals({}, 1) is None
    assert arrivals({"arrivals": {"process": "closed"}}, 1) is None
    spec = {"arrivals": {"process": "poisson", "rate_per_s": 50.0,
                         "block": 64}}
    a, b = arrivals(spec, 2 ** 33 + 1), arrivals(spec, 2 ** 33 + 2)
    ta = [next(a) for _ in range(128)]
    tb = [next(b) for _ in range(128)]
    again = arrivals(spec, 2 ** 33 + 1)
    assert ta == [next(again) for _ in range(128)]
    gaps = lambda t: [y - x for x, y in zip([0.0] + t, t)]
    for k in (0, 64):   # each block: the same gaps, in another order
        ga, gb = gaps(ta)[k:k + 64], gaps(tb)[k:k + 64]
        assert sorted(ga) == pytest.approx(sorted(gb)) and ga != gb
    assert 64 / ta[63] == pytest.approx(50.0, rel=0.05)
    with pytest.raises(ValueError):
        arrivals({"arrivals": {"process": "bursty"}}, 1)


# -- lookup by name, the result line, a new cell from files alone ------------


def test_every_cell_of_the_benchmark_is_found():
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in b["workloads"]:
        cell = harness.Cell(ROOT, w["name"])
        assert cell.config["entry"].startswith("brotli_tpu_torch:")
        names = [m["name"] for m in cell.end_to_end() + cell.per_layer()]
        assert "setup_s" in names and len(cell.per_layer()) >= 1
        for m in cell.end_to_end():
            assert callable(harness.load_reader(BENCH_DIR, "end_to_end",
                                              m["name"]).read)
        for m in cell.per_layer():
            assert callable(harness.load_reader(BENCH_DIR, "layers",
                                              m["name"]).read)


def test_new_cells_run_from_files_alone(tiny_root):
    for cell in ("gpu_q5.tiny", "batch_decode.tiny"):
        r = _run(tiny_root, cell)
        assert list(r)[:5] == KEYS and list(r)[-1] == "checks"
        assert r["correct"] is True and r["failed"] == 0
        assert r["attempted"] >= 1 and "setup_s" in r["metrics"]
        assert r["device"]["platform"] == "cpu"
        assert all(set(v) == {"value", "unit"} for v in
                   r["metrics"].values())


def test_open_loop_and_new_request_kind_from_files_alone(tiny_root):
    seconds, seed = 1.5, 2 ** 31 + 17
    r = _run(tiny_root, "batch_decode.open", seconds=seconds, seed=seed)
    assert r["correct"] is True and r["failed"] == 0
    t = arrivals(TINY_OPEN, seed)
    times = []
    while not times or times[-1] < seconds:
        times.append(next(t))
    # every request that arrived inside the window is served, no other
    assert r["attempted"] == max(1, len(times) - 1)
    r = _run(tiny_root, "gpu_copy.tiny")
    assert r["correct"] is True and list(r["checks"]) == [
        "bad_streams", "failed_requests"]


def test_metric_lookup_by_prefix_and_by_moves(tmp_path):
    assert harness.load_reader(BENCH_DIR, "layers",
                               "device_idle_share.any_entry").read
    with pytest.raises(FileNotFoundError):
        harness.load_reader(BENCH_DIR, "layers", "no_such_metric.decode")
    # a per-layer metric without `workloads` is reported in every cell
    # that reports the end-to-end metric it moves
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b["per_layer"].append({"name": "device_idle_share.all", "unit": "%",
                           "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "decode_MBps"})
    for c in b["configs"]:
        c["file"] = os.path.join(ROOT, c["file"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    rate = next(m for m in b["end_to_end"] if m["name"] == "decode_MBps")
    assert 0 < len(rate["workloads"]) < len(b["workloads"])
    for w in b["workloads"]:
        names = [m["name"] for m in
                 harness.Cell(str(tmp_path), w["name"]).per_layer()]
        assert ("device_idle_share.all" in names) is (
            w["name"] in rate["workloads"]), w["name"]


def test_traced_run_reports_span_metrics(tiny_root):
    r = _run(tiny_root, "gpu_q5.tiny", trace=True)
    m = r["metrics"]
    assert {"entry_self_share.compress", "host_parse_share.compress",
            "store_share.compress", "device_wait_share.compress"} <= set(m)
    assert "fold_roofline.compress" not in m   # no card, nothing to read
    assert 0 < m["host_parse_share.compress"]["value"] < 100
    r = _run(tiny_root, "batch_decode.tiny", trace=True)
    m = r["metrics"]
    assert {"host_leg_share.decode", "device_round_share.decode"} <= set(m)
    # one reader under two names in one cell: each reads the same spans
    for k in ("host_leg_share", "device_round_share"):
        assert m[k + ".serving"] == m[k + ".decode"]
    # the traced run leaves the program as it found it
    from brotli_tpu_torch.encode import gpu_path
    assert not hasattr(gpu_path._host_parse, "__wrapped__")


def test_no_card_fails_without_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "gpu_q5.bulk", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


# -- what the benchmark may import --------------------------------------------


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_of_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in
                        _imports(os.path.join(dirpath, f))}
                assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)
    tops = {m.split(".")[0] for m in
            _imports(os.path.join(BENCH_DIR, "reference.py"))}
    assert "brotli_tpu_torch" not in tops
    assert not any(m.split(".")[0] in FORBIDDEN for m in sys.modules)


def test_run_refuses_a_loaded_jax_module(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax.numpy"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "brotli_tpu_torch_x", object())
    assert run.forbidden_modules() == []


# -- the reference -------------------------------------------------------------


def test_reference_catches_a_corrupted_stream_and_a_wrong_byte():
    from brotli_tpu_torch import compress
    plain = corpus.make_files([40000], 3, {"source": 1, "zipf": 1})[0]
    s = compress(plain, quality=5)
    assert reference.bad_streams([(s, plain)]) == 0
    bad = s[:len(s) // 2] + bytes([s[len(s) // 2] ^ 1]) + s[len(s) // 2 + 1:]
    assert reference.bad_streams([(bad, plain)]) == 1
    assert reference.bad_streams([(s[:-3], plain)]) == 1
    assert reference.bad_streams([(s, plain[:-1] + b"?")]) == 1
    assert reference.bad_outputs([(plain, plain)]) == 0
    wrong = plain[:100] + bytes([plain[100] ^ 1]) + plain[101:]
    assert reference.bad_outputs([(wrong, plain), (None, plain)]) == 2


def test_system_encoder_streams_take_the_device_lane():
    from kinds.decode_batch import system_encoder
    from brotli_tpu_torch.decode.batch_gpu import _try_parse_stream
    plain = corpus.make_files([8192], 4, {"source": 1, "zipf": 1,
                                          "records": 1})[0]
    for q in (1, 3):
        s = system_encoder("brotlienc", q, 22, 0)(plain)
        assert reference.decode(s, len(plain)) == plain
        assert _try_parse_stream(s)[0] is not None   # one tree each


@pytest.mark.parametrize("cell", ["gpu_q5.tiny", "batch_decode.tiny"])
@pytest.mark.parametrize("fault", ["control", "alter", "unchanged", "half"])
def test_control_and_faults_come_out_not_correct(tiny_root, cell, fault):
    r = _run(tiny_root, cell, fault=fault, seed=5)
    assert r["correct"] is False
    assert any(c["value"] > c["at_most"] for c in r["checks"].values()
               if "at_most" in c)


# -- roofline counts, by hand ----------------------------------------------------


def test_fold_counts():
    # 10 rows, 1 key, 1 payload: keys, pos, payload read (3 x 4 bytes a
    # row), packed and score written (2 x 4): 200 bytes
    assert fold.fold_bytes(10, 1, 1) == 200
    assert fold.fold_bytes(4, 2, 2) == 4 * 4 * 5 + 32
    # 10 rows x 32 offsets x (1 key compare + 1 select)
    assert fold.fold_ops(10, 1, 32, 0) == 640
    assert fold.fold_ops(3, 2, 16, 8) == 3 * 24 * 3


def test_decode_step_counts():
    # 17 bits -> 3 bytes; lengths 4 x (256 + 704 + 40); state 40; 5
    # literals; 2 commands x 12; outputs 32
    assert decode_step.lane_bytes(100, 117, 40, 5, 2) == (
        3 + 4000 + 40 + 5 + 24 + 32)
    assert decode_step.lane_bytes(9, 9, 0, 0, 0) == 4 * 960 + 72


def test_peaks_bound():
    k = "NVIDIA H100 80GB HBM3"
    t, by = peaks.bound_s(3.35e12, 1.0, k)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = peaks.bound_s(1.0, 134e12, k)
    assert by == "operations" and t == pytest.approx(2.0)
    assert peaks.bound_s(1.0, 1.0, "some other card") is None


# -- span and trace arithmetic ----------------------------------------------------


def test_interval_arithmetic():
    iv = [(0, 2), (1, 3), (5, 6)]
    assert spans.union(iv) == [(0, 3), (5, 6)]
    assert spans.length(iv) == 4
    assert spans.inside([(1, 5.5)], iv) == 2.5


def test_wraps_record_and_restore(monkeypatch):
    import types
    mod = types.ModuleType("pb_probe_mod")
    mod.f = lambda x, y=2: x * y
    monkeypatch.setitem(sys.modules, "pb_probe_mod", mod)
    w = spans.Wraps()
    w.install("pb_probe_mod:f", [("k", lambda a, r: (a["x"], a["y"], r))])
    w.install("pb_probe_mod:nope")
    w.install("no_such_module_x:f")
    assert set(w.missing) == {"pb_probe_mod:nope", "no_such_module_x:f"}
    mod.f(3)                      # not recording: no span
    w.recording = True
    assert mod.f(3) == 6
    (s,) = w.spans["pb_probe_mod:f"]
    assert s.recs == {"k": (3, 2, 6)} and s.t1 >= s.t0
    w.restore()
    assert not hasattr(mod.f, "__wrapped__")


def test_device_trace_busy_and_gaps():
    ev = [("a", 10, 20), ("b", 15, 30), ("c", 50, 60)]
    dt = DeviceTrace(ev, 0, 100, 0, 5.0)
    assert dt.busy_s == 30e-9 and dt.window_s == 100e-9
    assert dt.idle_gaps() == [(0, 10), (30, 50), (60, 100)]
    assert dt.kernels("b") == [(15, 30)]
    assert dt.to_host(1e9) == 6.0


def test_window_from_markers():
    assert window_of([(10, 20), (500, 510)], 0, 480.0) == (10, 20, 500)
    # the end marker lost: the window ends the host clock's span later
    assert window_of([(10, 20)], 0, 480.0) == (10, 20, 490.0)
    # the first marker lost
    assert window_of([(500, 510)], 0, 480.0) == (20.0, 30.0, 500)
    with pytest.raises(RuntimeError):
        window_of([], 0, 480.0)


def test_breakdown_labels_gaps_by_innermost_span():
    class S:
        def __init__(self, t0, t1):
            self.t0, self.t1 = t0, t1

    class W:
        spans = {"m:inner": [S(2.0, 3.0)]}

    # trace ns = (host s - 1.0) * 1e9 (host0 1.0 at trace 0)
    ev = [("k1", int(0.5e9), int(1.5e9)), ("k2", int(2.5e9), int(2.6e9))]
    dt = DeviceTrace(ev, 0, int(4e9), 0, 1.0)
    reqs = [harness.Request(1.0, 4.0, 1, 1, True)]
    b = harness.breakdown(dt, W(), reqs, "entry")
    assert b["device_ops"][0][0] == "k1"
    gaps = dict(b["idle_gaps"])
    # gaps [0, .5] (host 1-1.5) and [1.5, 2.5] (host 2.5-3.5) and
    # [2.6, 4] (host 3.6-5): mid 1.25 entry, 3.0 inner, 4.3 harness
    assert gaps["entry"] == pytest.approx(0.5)
    assert gaps["m:inner"] == pytest.approx(1.0)
    assert gaps["harness (between calls)"] == pytest.approx(1.4)


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None, "control"])
def test_tiny_cells_on_the_card(cuda_card, tiny_root, fault):
    root, base = tiny_root
    for cell in ("gpu_q5.tiny", "batch_decode.tiny"):
        r = harness.run(root, cell, 7, 1.0, False, fault=fault, base=base)
        assert r["correct"] is (fault is None)
        assert r["device"]["platform"] == "gpu"
