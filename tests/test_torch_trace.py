"""Spans and counters of the two traced entry points (utils/trace.py).

compress_gpu and decompress_batch_gpu record only when the caller
passes `stats`: with stats=None they return the bytes and n_device of
the untraced program (compress_gpu: compress_tpu's stream), with a dict
the same, plus spans that nest (each inside its parent, the host-parse
steps inside host_parse) and counters that are exact on known inputs.
On the CPU, small inputs (the decoder's plain step loop takes about a
millisecond a step).
"""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

from . import oracle
from brotli_tpu.encode.tpu_path import compress_tpu
from brotli_tpu_torch import compress, compress_gpu, decompress_batch_gpu
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.decode import batch_gpu as B
from brotli_tpu_torch.encode import fast as TF
from brotli_tpu_torch.encode import gpu_path as G
from brotli_tpu_torch.encode.params import EncoderParams
from brotli_tpu_torch.utils import trace
from .test_torch_encoder import dictionary_slice, phrases
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPAN = 1 << 13
TEXT = phrases(14_000, seed=181) + dictionary_slice(40_000, 42_000)
RANDOM = np.random.default_rng(182).integers(0, 256, SPAN, np.uint8).tobytes()
DATA = TEXT[:2 * SPAN] + RANDOM + TEXT[2 * SPAN:]

COMPRESS_SPANS = {"compress_gpu", "entry.rows", "entry.call_setup",
                  "pipe.dispatch", "pipe.parse", "pipe.wait", "host_parse",
                  "host_parse.invert", "host_parse.extend",
                  "host_parse.dict_probe", "host_parse.walk",
                  "host_parse.commands",
                  "store.context", "store.literals", "store.split",
                  "split.device", "split.hysteresis", "split.merge",
                  "store.metablock", "store.raw"}
DECODE_SPANS = {"decompress_batch_gpu", "walk.native", "walk.python",
                "walk.resume", "round.lanes", "round.kernel",
                "round.copy_back", "reconstruct", "assemble", "fallback"}


def _names(stats):
    return [s[0] for s in stats["spans"]]


def _off():
    """No recorder is current: a span is the shared no-op."""
    return trace.span("probe") is trace.recording("probe", None)


def _assert_nested(spans):
    """The root first; every other span inside its parent, which opened
    before it; siblings in order, apart."""
    name, parent, t0, t1 = spans[0]
    assert parent == -1 and t0 <= t1
    last_end = {}
    for k, (name, parent, t0, t1) in enumerate(spans[1:], 1):
        assert 0 <= parent < k, (k, name, parent)
        _, _, p0, p1 = spans[parent]
        assert p0 <= t0 <= t1 <= p1, (name, spans[parent][0])
        assert t0 >= last_end.get(parent, p0)
        last_end[parent] = t1


# -- the recorder ------------------------------------------------------


def test_off_costs_no_recorder_and_no_allocation():
    off = trace.recording("root", None)
    assert trace.span("a") is trace.span("b") is off   # one shared object
    with off as s:
        with trace.span("a") as t:
            assert s is None and t is None
        trace.count("a")                          # nothing to count into
    assert _off()


def test_recording_nests_counts_and_resets():
    stats = {}
    rec = trace.recording("root", stats, ("c", "unused"), {"a_s": "a"})
    with rec:
        with trace.span("a"):
            with trace.span("a.x"):
                trace.count("c")
            trace.count("c")
        with trace.span("b"):
            trace.count("other")
        with trace.span("a"):
            pass
    with trace.span("late"):                      # the recorder is gone
        trace.count("c")
    assert _off() and len(rec.spans) == 5
    assert _names(stats) == ["root", "a", "a.x", "b", "a"]
    spans = stats["spans"]
    assert [s[1] for s in spans] == [-1, 0, 1, 0, 0]
    _assert_nested(spans)
    assert (stats["c"], stats["unused"], stats["other"]) == (2, 0, 1)
    assert stats["a_s"] == sum(s[3] - s[2] for s in spans
                               if s[0] == "a") / 1e9
    assert stats["wall_s"] == (spans[0][3] - spans[0][2]) / 1e9 > 0
    assert all(isinstance(stats[k], int) for k in ("c", "unused", "other"))


def test_recording_closes_spans_on_an_exception():
    stats = {}
    with pytest.raises(ValueError):
        with trace.recording("root", stats):
            with trace.span("a"):
                raise ValueError("x")
    assert _off()
    assert _names(stats) == ["root", "a"]
    _assert_nested(stats["spans"])


def test_recording_is_per_context():
    """A thread started inside a traced call records nothing; an inner
    traced call records apart and hands the outer one back."""
    seen = []
    outer, inner = {}, {}
    with trace.recording("outer", outer):
        t = threading.Thread(target=lambda: seen.append(_off()))
        t.start()
        t.join()
        with trace.recording("inner", inner):
            with trace.span("x"):
                pass
        with trace.span("y"):
            pass
    assert seen == [True]
    assert _names(inner) == ["inner", "x"]
    assert _names(outer) == ["outer", "y"]


# -- compress_gpu ------------------------------------------------------


@pytest.mark.parametrize("quality", range(2, 10))
def test_compress_gpu_untraced_bytes_unchanged(quality):
    want = compress_tpu(DATA, quality=quality, span=SPAN)
    assert compress_gpu(DATA, quality=quality, span=SPAN,
                        device="cpu") == want
    stats = {}
    assert compress_gpu(DATA, quality=quality, span=SPAN, stats=stats,
                        device="cpu") == want
    if oracle.available():
        assert oracle.decompress(want) == DATA


def _traced_compress(quality, **kw):
    stats = {}
    out = compress_gpu(DATA, quality=quality, span=SPAN, stats=stats,
                       device="cpu", **kw)
    assert out == compress_gpu(DATA, quality=quality, span=SPAN,
                               device="cpu", **kw)
    return stats


@pytest.mark.parametrize("quality,max_device", [
    (2, False), (5, False), (7, False), (9, False), (5, True), (9, True)])
def test_compress_gpu_spans_nest(quality, max_device):
    stats = _traced_compress(quality, max_device=max_device)
    spans = stats["spans"]
    _assert_nested(spans)
    names = _names(stats)
    assert names[0] == "compress_gpu" and set(names) <= COMPRESS_SPANS
    n_spans = -(-len(DATA) // SPAN)
    assert names.count("pipe.wait") == names.count("host_parse") == n_spans
    assert names.count("pipe.dispatch") == n_spans
    for k, (name, parent, _, _) in enumerate(spans):
        if name.startswith("host_parse."):
            assert spans[parent][0] == "host_parse"
        if name in ("pipe.wait", "host_parse") or name.startswith("store."):
            assert parent == 0, name
    kids = [names[k] for k, s in enumerate(spans) if s[1] >= 0
            and spans[s[1]][0] == "host_parse"]
    want = ["host_parse.commands"] * n_spans if max_device else [
        "host_parse.invert", "host_parse.extend", "host_parse.dict_probe",
        "host_parse.walk"] * n_spans
    assert kids == want
    # max_device: the device parse, once a span, inside its dispatch
    parse = [spans[s[1]][0] for s in spans if s[0] == "pipe.parse"]
    assert parse == ["pipe.dispatch"] * (n_spans if max_device else 0)
    root = spans[0]
    assert stats["wall_s"] == (root[3] - root[2]) / 1e9
    waits = sum(s[3] - s[2] for s in spans if s[0] == "pipe.wait")
    assert stats["device_wait_s"] == waits / 1e9 <= stats["wall_s"]


@pytest.mark.parametrize("quality", [3, 5, 9])
def test_compress_gpu_span_counts_exact(quality):
    stats = _traced_compress(quality)
    names = _names(stats)
    n_spans = -(-len(DATA) // SPAN)
    assert names.count("store.metablock") == n_spans
    # the random span, and only it, is stored uncompressed
    assert names.count("store.raw") == 1
    hosts = [k for k, n in enumerate(names) if n == "host_parse"]
    raw = names.index("store.raw")
    assert [h < raw for h in hosts] == [True] * 3 + [False] * (n_spans - 3)


@pytest.mark.parametrize("invert", ["0", "1"])
def test_compress_gpu_host_leg_calls_inside_their_spans(invert,
                                                        monkeypatch):
    """The inversion, the cap extension and the merge of the dictionary
    candidates run inside the host_parse children that name them."""
    monkeypatch.setenv("BROTLI_TPU_TORCH_DEVICE_INVERT", invert)
    calls = {"host_parse.invert": [], "host_parse.extend": [],
             "host_parse.dict_probe": []}

    def spy(fn, name):
        def call(*a, **kw):
            calls[name].append(time.perf_counter_ns())
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(nb, "invert_perm32",
                        spy(nb.invert_perm32, "host_parse.invert"))
    monkeypatch.setattr(nb, "extend_caps",
                        spy(nb.extend_caps, "host_parse.extend"))
    monkeypatch.setattr(G, "merge_candidates",
                        spy(G.merge_candidates, "host_parse.dict_probe"))
    stats = {}
    compress_gpu(DATA, quality=5, span=SPAN, stats=stats, device="cpu")
    n_spans = -(-len(DATA) // SPAN)
    assert len(calls["host_parse.invert"]) == (n_spans if invert == "0"
                                               else 0)
    assert calls["host_parse.extend"]        # repeated phrases
    assert len(calls["host_parse.dict_probe"]) == n_spans
    for name, ts in calls.items():
        ivs = [(t0, t1) for n, _, t0, t1 in stats["spans"] if n == name]
        assert len(ivs) == n_spans
        assert all(any(t0 <= t <= t1 for t0, t1 in ivs) for t in ts), name


@pytest.mark.parametrize("max_device", [False, True])
def test_compress_gpu_split_spans(max_device):
    """A literal split that reaches the Lloyd loop records split.device,
    split.hysteresis and split.merge, in that order, inside its
    store.split; a split that returns before it records none."""
    stats = _traced_compress(5, max_device=max_device)
    spans = stats["spans"]
    kids = {k: [] for k, s in enumerate(spans) if s[0] == "store.split"}
    for name, parent, _, _ in spans:
        if name.startswith("split."):
            kids[parent].append(name)
    # the random span's 8,192 literals: 32 chunks, 10 types
    assert ["split.device", "split.hysteresis", "split.merge"] in \
        list(kids.values())
    assert all(v in ([], ["split.device", "split.hysteresis",
                          "split.merge"]) for v in kids.values())


def test_compress_gpu_empty_input_traced():
    stats = {}
    assert compress_gpu(b"", quality=5, stats=stats,
                        device="cpu") == compress_gpu(b"", quality=5,
                                                      device="cpu")
    assert _names(stats) == ["compress_gpu"]
    assert stats["device_wait_s"] == 0.0


def test_compress_gpu_no_runtime_spans(monkeypatch):
    """Without the runtime the pure-Python store, raw blocks included,
    is the store.metablock span."""
    monkeypatch.setenv(nb.NO_NATIVE_ENV, "1")
    data = TEXT[:3000] + RANDOM[:4096]
    stats = {}
    out = compress_gpu(data, quality=5, span=4096, stats=stats,
                       device="cpu")
    assert out == compress_gpu(data, quality=5, span=4096, device="cpu")
    names = _names(stats)
    _assert_nested(stats["spans"])
    assert names.count("store.metablock") == names.count("host_parse") == 2
    assert "store.context" not in names and "store.raw" not in names
    monkeypatch.delenv(nb.NO_NATIVE_ENV)
    if oracle.available():
        assert oracle.decompress(out) == data


def test_compress_gpu_stats_keys():
    stats = _traced_compress(4)
    assert set(stats) == {"wall_s", "device_wait_s", "spans",
                          *G.DICT_COUNTERS, *G.PARSE_COUNTERS,
                          *G.MATCH_COUNTERS}


def _short_won_by_span(quality):
    """The positions of each span of DATA whose q9 merge takes the short
    fold's match (its score strictly above the exact8 fold's), from the
    two folds' sorted-space outputs inverted on the host."""
    params = EncoderParams(quality=quality).sanitize(len(DATA))
    halo = -(-(params.window_size + 16) // 4096) * 4096
    knobs = G._device_knobs(params.quality)
    rows, min_pos = G._halo_rows(np.frombuffer(DATA, np.uint8), SPAN, halo)
    won = []
    for j, row in enumerate(rows):
        pos8, _, sc8, pos_s, _, sc_s = [x.numpy() for x in G._match_dense(
            torch.from_numpy(row), int(min_pos[j]), params.window_size,
            halo, **knobs)]
        a, b = np.empty_like(sc8), np.empty_like(sc_s)
        a[pos8], b[pos_s] = sc8, sc_s
        real = min(SPAN, len(DATA) - j * SPAN)
        won.append(int((b > a)[halo:halo + real].sum()))
    return won


@pytest.mark.parametrize("invert", ["0", "1"])
@pytest.mark.parametrize("quality", [5, 7, 9])
def test_compress_gpu_match_counters(quality, invert, monkeypatch):
    """q9 counts every position its merge takes and those the short
    fold wins, exactly, on either inversion route; q5 and q7, which
    merge nothing, count none."""
    monkeypatch.setenv("BROTLI_TPU_TORCH_DEVICE_INVERT", invert)
    stats = _traced_compress(quality)
    if quality < 9:
        assert [stats[k] for k in G.MATCH_COUNTERS] == [0, 0]
        return
    assert stats["match.positions"] == len(DATA)
    assert stats["match.short_won"] == sum(_short_won_by_span(quality)) > 0


@pytest.mark.parametrize("invert", ["0", "1"])
def test_compress_gpu_match_count_only_traced(invert, monkeypatch):
    """The device counts the short fold's wins only in a traced q9
    call, once a span: an untraced call asks the matcher for no count."""
    monkeypatch.setenv("BROTLI_TPU_TORCH_DEVICE_INVERT", invert)
    asked = []
    match = G._match_dense

    def spy(*a, **kw):
        asked.append(kw.get("short_won"))
        return match(*a, **kw)

    monkeypatch.setattr(G, "_match_dense", spy)
    n_spans = -(-len(DATA) // SPAN)
    compress_gpu(DATA, quality=9, span=SPAN, device="cpu")
    assert asked == [None] * n_spans
    asked.clear()
    compress_gpu(DATA, quality=9, span=SPAN, stats={}, device="cpu")
    assert len(asked) == n_spans and None not in asked


@pytest.mark.parametrize("quality,max_device", [
    (2, False), (5, False), (9, False), (5, True)])
def test_compress_gpu_dict_counters(quality, max_device):
    """The probe takes every position once and the dictionary some of
    the text's positions; max_device probes nothing."""
    stats = _traced_compress(quality, max_device=max_device)
    if max_device:
        assert [stats[k] for k in G.DICT_COUNTERS] == [0, 0]
        return
    assert stats["dict.positions"] == len(DATA)
    assert 0 < stats["dict.won"] < len(DATA)


@pytest.mark.parametrize("quality,max_device", [
    (5, False), (9, False), (2, True), (5, True), (9, True)])
def test_compress_gpu_parse_counters(quality, max_device):
    """max_device's parse covers every input position once, its copies
    some of them; the default path counts none."""
    stats = _traced_compress(quality, max_device=max_device)
    if not max_device:
        assert [stats[k] for k in G.PARSE_COUNTERS] == [0, 0]
        return
    assert stats["parse.positions"] == len(DATA)
    assert 0 < stats["parse.copied"] < stats["parse.positions"]


# -- decompress_batch_gpu ----------------------------------------------


def _fast_stream(data, shard):
    old = TF.SHARD
    TF.SHARD = shard
    try:
        return TF.compress_fast(data, lgwin=18, device="cpu")
    finally:
        TF.SHARD = old


PLAIN = [TEXT[:700], TEXT[1000:1700], TEXT[3000:4600], TEXT[5000:8000], b""]


@pytest.fixture(scope="module")
def batch_streams():
    """google's q1 (a compressed metablock, then an empty last one: a
    walk and one resume), google's q3 (one walk), a stream of four
    400-byte metablocks (a walk, three resumes, four rounds), a q11
    stream (the host decoder) and a walk-only stream."""
    if not oracle.available():
        pytest.skip("libbrotlienc is needed for google's streams")
    return [oracle.compress(PLAIN[0], quality=1),
            oracle.compress(PLAIN[1], quality=3),
            _fast_stream(PLAIN[2], 400),
            compress(PLAIN[3], quality=11),
            b"\x3b"]


def _decode_twice(streams):
    plain = decompress_batch_gpu(streams, device="cpu")
    stats = {}
    traced = decompress_batch_gpu(streams, device="cpu", stats=stats)
    return streams, plain, traced, stats


@pytest.fixture(scope="module")
def batch(batch_streams):
    """The streams decoded untraced and traced: the native walk takes
    every walk, first or resumed, but the q11 stream's, which it
    refuses (more than one block type) and the Python walk declines."""
    return _decode_twice(batch_streams)


@pytest.fixture(scope="module")
def batch_no_runtime(batch_streams):
    """The same with BROTLI_TPU_TORCH_NO_NATIVE set: every walk in
    Python."""
    mp = pytest.MonkeyPatch()
    mp.setenv(nb.NO_NATIVE_ENV, "1")
    try:
        return _decode_twice(batch_streams)
    finally:
        mp.undo()


def test_decode_untraced_outputs_unchanged(batch):
    streams, plain, traced, _ = batch
    assert plain == (PLAIN, 3)
    assert traced == plain


def _count(batch, key):
    _, _, (_, n_device), stats = batch
    if key == "n_device":
        return n_device
    return stats[key] if key in stats else _names(stats).count(key)


@pytest.mark.parametrize("key,want", [
    ("walks_native", 8), ("walks_python", 1), ("walks_resumed", 0),
    ("round.kernel", 4), ("reconstruct", 6), ("fallback", 1),
    ("n_device", 3)])
def test_decode_counts_exact(batch, key, want):
    """Counters, spans counted by name, and the returned n_device: the
    native walk takes the five first walks but the q11 stream's and
    the four resumes (q1's and the 400-byte stream's three)."""
    assert _count(batch, key) == want


@pytest.mark.parametrize("key,want", [
    ("walks_native", 0), ("walks_python", 5), ("walks_resumed", 4),
    ("walk.native", 0), ("round.kernel", 4), ("reconstruct", 6),
    ("fallback", 1), ("n_device", 3)])
def test_decode_counts_exact_no_runtime(batch_no_runtime, key, want):
    """Without the runtime every first walk and every resume runs in
    Python, and the outputs are the same."""
    assert batch_no_runtime[2] == (PLAIN, 3)
    assert _count(batch_no_runtime, key) == want


def test_decode_spans_nest(batch):
    stats = batch[3]
    spans = stats["spans"]
    _assert_nested(spans)
    names = _names(stats)
    assert names[0] == "decompress_batch_gpu" and set(names) <= DECODE_SPANS
    assert all(s[1] == 0 for s in spans[1:])   # every span under the root
    # with the runtime the native walk is tried on every walk, first or
    # resumed; the Python walks are those it refused
    walks = sum(stats[k] for k in B.DECODE_COUNTERS)
    assert names.count("walk.native") == walks
    assert names.count("walk.python") == stats["walks_python"]
    assert names.count("walk.resume") == stats["walks_resumed"]
    for part in ("round.lanes", "round.copy_back"):
        assert names.count(part) == names.count("round.kernel")
    assert stats["wall_s"] == (spans[0][3] - spans[0][2]) / 1e9


def test_decode_rounds_in_order(batch):
    """Each round's lanes, kernel and copy back follow each other."""
    spans = batch[3]["spans"]
    parts = [s for s in spans if s[0].startswith("round.")]
    assert [s[0] for s in parts] == ["round.lanes", "round.kernel",
                                     "round.copy_back"] * 4
    assert all(a[3] <= b[2] for a, b in zip(parts, parts[1:]))


@pytest.mark.parametrize("n_meta", [2, 3, 5])
def test_decode_multi_metablock_rounds(n_meta):
    """A stream of n 256-byte metablocks: n native walks (the first
    and n - 1 resumes), n rounds of one lane."""
    plain = TEXT[2000:2000 + 256 * n_meta]
    s = _fast_stream(plain, 256)
    stats = {}
    assert decompress_batch_gpu([s], device="cpu", stats=stats) == (
        [plain], 1)
    assert (stats["walks_native"], stats["walks_python"],
            stats["walks_resumed"]) == (n_meta, 0, 0)
    names = _names(stats)
    assert names.count("round.kernel") == names.count("reconstruct") == n_meta
    _assert_nested(stats["spans"])


def test_decode_round_budget_falls_back():
    """Lanes left when max_rounds is spent go to the host decoder."""
    plain = TEXT[2000:2768]
    s = _fast_stream(plain, 256)
    stats = {}
    assert decompress_batch_gpu([s], max_rounds=1, device="cpu",
                                stats=stats) == ([plain], 0)
    assert _names(stats).count("round.kernel") == 1
    assert _names(stats)[-1] == "fallback"


def test_decode_stats_on_a_refused_stream_that_raises():
    """A stream the host decoder rejects raises as untraced; the call's
    spans are written and the recorder is gone."""
    good = b"\x3b"
    stats = {}
    with pytest.raises(B.BrotliDecodeError):
        decompress_batch_gpu([bytes([good[0] | 0x80])], device="cpu",
                             stats=stats)
    assert _off()
    assert _names(stats)[0] == "decompress_batch_gpu"
    assert _names(stats)[-1] == "fallback"
    _assert_nested(stats["spans"])
    assert _names(stats).count("fallback") == 1


def test_decode_stats_keys():
    stats = {}
    assert decompress_batch_gpu([b"\x3b"], device="cpu", stats=stats) == (
        [b""], 0)
    assert set(stats) == {"wall_s", "spans", *B.DECODE_COUNTERS}
    assert _names(stats) == ["decompress_batch_gpu", "walk.native",
                             "assemble"]


# -- the benchmark's wrap points ---------------------------------------

# The module attributes a traced benchmark run replaces with span
# wrappers (perfbench/spans.py's wrap points, perfbench/card_parse.py's
# spies), with the entry each runs under.  The program must look each up
# when it calls it, so that the replacement sees every call.
WRAP_POINTS = [
    ("brotli_tpu_torch.encode.gpu_path:_host_parse", "compress"),
    ("brotli_tpu_torch.encode.gpu_path:_Pipeline.wait", "compress"),
    ("brotli_tpu_torch.encode.gpu_path:split_symbols_device", "compress"),
    ("brotli_tpu_torch.encode.gpu_path:best_matches_exact_p", "compress"),
    ("brotli_tpu_torch.encode.gpu_path:_match_parse_dense", "max_device"),
    ("brotli_tpu_torch.encode.gpu_path:_commands_from_parse", "max_device"),
    ("brotli_tpu_torch.encode.gpu_path:compress_gpu", "compress"),
    ("brotli_tpu_torch.native_bridge:encode_metablock", "compress"),
    ("brotli_tpu_torch.ops.fold_cuda:fold_sorted", "compress"),
    ("brotli_tpu_torch.decode.batch_gpu:_try_parse_stream", "decode"),
    ("brotli_tpu_torch.decode.batch_gpu:_resume_parse_stream", "decode"),
    ("brotli_tpu_torch.decode.batch_gpu:_run_device", "decode"),
    ("brotli_tpu_torch.decode.batch_gpu:lane_arrays", "decode"),
    ("brotli_tpu_torch.decode.batch_gpu:_reconstruct", "decode"),
]


@pytest.fixture(scope="module")
def wrap_entries():
    """Each entry's call, through its module's attribute, and the
    unpatched outputs, filled as the cases ask for them.  The decoder
    takes a stream of four 400-byte metablocks (a walk, three resumes,
    four rounds) and a walk-only stream."""
    streams = [_fast_stream(PLAIN[2], 400), b"\x3b"]
    calls = {
        "compress": lambda: G.compress_gpu(DATA, quality=5, span=SPAN,
                                           device="cpu"),
        "max_device": lambda: G.compress_gpu(DATA, quality=5, span=SPAN,
                                             max_device=True, device="cpu"),
        "decode": lambda: B.decompress_batch_gpu(streams, device="cpu"),
    }
    return calls, {}


@pytest.mark.parametrize("point,entry", WRAP_POINTS,
                         ids=[p for p, _ in WRAP_POINTS])
def test_wrap_point_sees_every_call(point, entry, wrap_entries, monkeypatch):
    """A counting pass-through put on the attribute is called, and the
    entry's output is the unpatched one."""
    calls, unpatched = wrap_entries
    if entry not in unpatched:
        unpatched[entry] = calls[entry]()
    mod_name, _, path = point.partition(":")
    owner = importlib.import_module(mod_name)
    *outer, attr = path.split(".")
    for name in outer:
        owner = getattr(owner, name)
    fn = getattr(owner, attr)
    seen = []

    def spy(*a, **kw):
        seen.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(owner, attr, spy)
    assert calls[entry]() == unpatched[entry]
    assert seen, point
