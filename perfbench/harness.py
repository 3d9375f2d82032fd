"""One run of one cell: set-up, the measured window, the metrics and the
check against the reference.

Everything particular to a cell is found by name: the cell, its
configuration file and its traffic mix through BENCHMARK.json, the mix's
parameters in traffic/<name>.json, the configuration's request kind in
kinds/<request>.py, each end-to-end metric's reader in
end_to_end/<name>.py and each per-layer metric's reader in
layers/<name>.py (or, where there is no such file, layers/<prefix>.py,
the name up to its first dot: one reader for the metric of each
entry).  A configuration names the program's entry point
("module:attr"), its keyword arguments and its request kind.

A request kind's module has a class `Requests(config, traffic, seed,
device)` that makes the pool from the seed, with `describe()` (the
inputs' sha256, printed before the window), `warm()` and `order()` (the
requests of set-up and of the window), `payload(x)` (what the entry is
called with), `size_in(payload)`, `answered(r, x, payload, answer)` (the
bytes out; keeps what the check needs), `check(n_requests, failed)`
(the numbers compared, each (value, "at_most" or "at_least", limit),
and a line for the log) and `broken(call, fault, seed)` (faults.py).
The loop itself, closed or open at a rate, is the mix's `arrivals`
(traffic.py).

A reader module has `read(ctx)`, which returns the metric or None
where it finds nothing to read (the metric is then left out of the
line), and may have `WRAPS` (wrap points, or (point, record function)
pairs, spans.py) and `COUNTERS` (a keyword argument of the entry that
takes a dict the program fills).  Wrappers and counters exist only in
the traced run.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import inspect
import json
import os
import sys
import time

import spans as spans_mod
from traffic import arrivals

HERE = os.path.dirname(os.path.abspath(__file__))
LABEL_CHARS = 96


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def process_start() -> float:
    """This process's start on the CLOCK_BOOTTIME clock (Linux: field 22
    of /proc/self/stat, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def boot_now() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


# --------------------------------------------------------------------------
# Finding things by name
# --------------------------------------------------------------------------


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json with its configuration and mix."""

    def __init__(self, root: str, name: str, base: str = HERE):
        self.base = base
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        cfgs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = cfgs[self.workload["config"]]
        self.config = load_json(os.path.join(root,
                                              self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            base, "traffic", self.workload["traffic"] + ".json"))

    def _applies(self, metric: dict, reported: set) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return metric.get("moves", metric["name"]) in reported

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports."""
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self._applies(m, reported)]


def _load_file(path: str, mod_name: str):
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(base: str, kind: str, name: str):
    """The reader module of metric `name` in `kind` (end_to_end or
    layers) under the harness directory `base`: <kind>/<name>.py, or
    <kind>/<prefix>.py for the name up to its first dot."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(base, kind, stem + ".py")
        if os.path.exists(path):
            # a module a metric, so that two metrics of one reader in
            # one cell keep their records apart
            return _load_file(path, "perfbench_%s_%s" % (
                kind, name.replace(".", "_").replace("-", "_")))
    raise FileNotFoundError(f"no reader {kind}/{name}.py")


def load_kind(base: str, name: str):
    """The request kind module kinds/<name>.py under `base`."""
    path = os.path.join(base, "kinds", name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no request kind kinds/{name}.py")
    return _load_file(path, "perfbench_kind_" + name.replace("-", "_"))


def resolve(spec: str):
    """The object at "module:attr"."""
    mod_name, _, attr = spec.partition(":")
    obj = importlib.import_module(mod_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


# --------------------------------------------------------------------------
# The run
# --------------------------------------------------------------------------


class Request:
    """One request of the window: arrival `t0`, call `t_call` (later than
    t0 where an open loop's request waited for the server), return
    `t1`, on the host's perf_counter clock."""
    __slots__ = ("t0", "t_call", "t1", "bytes_in", "bytes_out", "ok")

    def __init__(self, t0, t1, bytes_in, bytes_out, ok, t_call=None):
        self.t0, self.t1 = t0, t1
        self.t_call = t0 if t_call is None else t_call
        self.bytes_in, self.bytes_out, self.ok = bytes_in, bytes_out, ok

    @property
    def latency_s(self) -> float:
        return self.t1 - self.t0


class Ctx:
    """What the readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def spans(self, point: str) -> list:
        return self.wraps.spans.get(point, [])

    def calls(self) -> list:
        return [(r.t_call, r.t1) for r in self.requests]


def _wrap_points(reader) -> list:
    out = []
    for w in getattr(reader, "WRAPS", ()):
        out.append((w, None) if isinstance(w, str) else (w[0], w[1]))
    return out


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device=None, fault=None, t_process=None, base: str = HERE) -> dict:
    """One run.  device None runs on CUDA (the caller has checked for
    it); "cpu" is for the tests, as are `fault` (a request kind's
    broken()) and `base` (another harness directory for the traffic
    mixes, request kinds and readers).  Returns the result line's dict;
    the reference's numbers, each with its limit, under "checks"."""
    cell = Cell(root, workload, base)
    cfg = cell.config
    kind = load_kind(cell.base, cfg["request"])
    cuda = device is None
    import torch
    if cuda:
        torch.cuda.init()
    entry = resolve(cfg["entry"])
    kwargs = dict(cfg.get("kwargs", {}))
    if device is not None:
        kwargs["device"] = device
    req = kind.Requests(cfg, cell.traffic, seed, device)
    print(req.describe(), flush=True)

    # the traced run's readers, wrappers and counters
    readers, wraps = {}, spans_mod.Wraps()
    counters_kw = None
    if trace:
        for m in cell.per_layer():
            readers[m["name"]] = load_reader(cell.base, "layers", m["name"])
        params = inspect.signature(entry).parameters
        for name, rd in readers.items():
            ck = getattr(rd, "COUNTERS", None)
            if ck is not None and ck not in params:
                log(f"metric {name}: the entry takes no {ck}=; left out")
            elif ck is not None:
                counters_kw = ck

    def base_call(x):
        if counters_kw is not None:
            c = {}
            counters.append(c)
            return entry(x, **kwargs, **{counters_kw: c})
        return entry(x, **kwargs)

    call = base_call if fault is None else req.broken(base_call, fault, seed)
    counters = []

    # warm-up: every shape this cell's traffic uses, once
    order = req.order()
    arrive = arrivals(cell.traffic, seed)
    for x in req.warm():
        call(req.payload(x))
    counters.clear()
    if cuda:
        torch.cuda.synchronize()

    if trace:
        for name, rd in readers.items():
            for point, rec in _wrap_points(rd):
                wraps.install(point, [(rd.__name__, rec)] if rec else [])
        for point, why in wraps.missing.items():
            log(f"wrap point {point} missing: {why}")
    tracer = None
    if trace and cuda:
        from devtrace import Tracer
        tracer = Tracer().__enter__()

    # the window; what set-up made is moved out of the collector's way,
    # so that a collection in the window walks only what the window makes
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    requests = []
    wraps.clear()
    wraps.recording = True
    if tracer is not None:
        tracer.mark()
    t_setup_end = boot_now()
    t_start = time.perf_counter()
    r = 0
    while True:
        x = next(order)
        payload = req.payload(x)
        if arrive is None:     # closed loop: the next call at once
            t0 = time.perf_counter()
        else:                  # open loop: the call waits for its arrival
            t0 = t_start + next(arrive)
            if requests and t0 - t_start >= seconds:
                break
            wait = t0 - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        t_call = time.perf_counter()
        try:
            answer, ok = call(payload), True
        except Exception as e:  # a failed request is counted
            answer, ok = None, False
            log(f"request {r} failed: {e!r}")
        t1 = time.perf_counter()
        out = req.answered(r, x, payload, answer) if ok else 0
        requests.append(Request(t0, t1, req.size_in(payload), out, ok,
                                t_call))
        answer = payload = None
        r += 1
        if arrive is None and t1 - t_start >= seconds:
            break
    t_end = requests[-1].t1
    wraps.recording = False
    gc.unfreeze()
    if tracer is not None:
        tracer.mark()
    if cuda:
        torch.cuda.synchronize()
        mem_peak = torch.cuda.max_memory_allocated()
    window_s = t_end - t_start
    dev_trace = None
    if tracer is not None:
        tracer.__exit__(None, None, None)
        dev_trace = tracer.read()
    wraps.restore()

    setup_s = t_setup_end - (process_start() if t_process is None
                             else t_process)
    ctx = Ctx(cell=cell.name, config=cfg, window_s=window_s,
              requests=requests, setup_s=setup_s, wraps=wraps,
              counters=counters, device=dev_trace,
              kind=torch.cuda.get_device_name() if cuda else "cpu")

    # the metrics
    metrics = {}
    if trace:
        for m in cell.per_layer():
            rd = readers[m["name"]]
            gone = [p for p, _ in _wrap_points(rd) if p in wraps.missing]
            if gone:
                log(f"metric {m['name']}: wrap points {gone} missing; "
                    "left out")
                continue
            v = rd.read(ctx)
            if v is None:
                log(f"metric {m['name']}: nothing to read; left out")
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            v = load_reader(cell.base, "end_to_end", m["name"]).read(ctx)
            if v is None:
                log(f"metric {m['name']}: nothing to read; left out")
                continue
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check against the reference, once the window has closed
    failed = sum(1 for q in requests if not q.ok)
    checks, said = req.check(len(requests), failed)
    log(said)
    correct = all((v >= lim) if rule == "at_least" else (v <= lim)
                  for v, rule, lim in checks.values())

    result = {"correct": bool(correct), "attempted": len(requests),
              "failed": failed, "metrics": metrics}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": ctx.kind,
           "count": int(cell.workload["chips"]),
           "memory_peak_bytes": int(mem_peak) if cuda else 0}
    if dev_trace is not None:
        dev["busy_s"] = dev_trace.busy_s
        dev["window_s"] = dev_trace.window_s
        result["breakdown"] = breakdown(dev_trace, wraps, requests,
                                        cfg["entry"])
    result["device"] = dev
    result["checks"] = {name: {"value": v, rule: lim}
                        for name, (v, rule, lim) in checks.items()}
    return result


def breakdown(dt, wraps, requests, entry_name: str) -> dict:
    """The ten device operations that took most time (summed by name),
    and the idle time of the device summed by the innermost span open on
    the host (the entry's own code where only the call is open, the
    harness between calls)."""
    by_op = {}
    for n, a, b in dt.events:
        key = n[:LABEL_CHARS]
        by_op[key] = by_op.get(key, 0.0) + (b - a) / 1e9
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    # a sweep over span starts and ends and the gaps' midpoints (on the
    # host clock): the innermost open span is the latest started
    marks = [(q.t_call, 0, entry_name) for q in requests]
    marks += [(q.t1, 2, entry_name) for q in requests]
    for point, sp in wraps.spans.items():
        marks += [(s.t0, 0, point) for s in sp]
        marks += [(s.t1, 2, point) for s in sp]
    gaps = dt.idle_gaps()
    marks += [(dt.to_host((a + b) / 2), 1, k) for k, (a, b) in
              enumerate(gaps)]
    marks.sort(key=lambda m: (m[0], m[1]))
    open_, by_span = [], {}
    for t, what, x in marks:
        if what == 0:
            open_.append(x)
        elif what == 2:
            open_.reverse()
            open_.remove(x)
            open_.reverse()
        else:
            label = open_[-1] if open_ else "harness (between calls)"
            a, b = gaps[x]
            by_span[label] = by_span.get(label, 0.0) + (b - a) / 1e9
    gaps = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
