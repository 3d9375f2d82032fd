"""Spans and counters inside one call of an entry point.

An entry that takes `stats=` runs its body under
`with recording(name, stats, counters, sums):`.  With stats None that
is a shared no-op; with a dict it makes the call's recorder current (a
ContextVar, so no helper's signature changes) and opens the root span
`name`.  On leaving, it writes `stats["wall_s"]`, the root span in
seconds, `stats["spans"]`, a list of (name, parent, t0_ns, t1_ns) in
the order the spans opened, with the index of the span open around each
(-1 for the root), one integer key per counter (every name of
`counters`, 0 where nothing counted) and, for each `key: name` of
`sums`, the summed length of the spans `name` in seconds.
Times are time.perf_counter_ns(), the host clock perf_counter reads.

Everywhere below an entry, `span(name)`, `count(name)` and `on()` cost
one ContextVar lookup and one `is None` test where no recorder is
current: no clock read, no allocation.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

_now = time.perf_counter_ns
_current = contextvars.ContextVar("brotli_tpu_torch_trace", default=None)

_OFF = contextlib.nullcontext()   # shared: reusable, allocates nothing


class _Span:
    __slots__ = ("rec", "name", "k")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.k = len(rec.spans)
        rec.spans.append([self.name, rec.open[-1], _now(), 0])
        rec.open.append(self.k)

    def __exit__(self, *exc):
        rec = self.rec
        rec.spans[self.k][3] = _now()
        rec.open.pop()
        return False


class _Recording:
    """The spans and counters of one traced call."""

    def __init__(self, name, stats, counters, sums):
        self.stats, self.sums = stats, sums
        self.spans, self.open = [], [-1]
        self.counts = dict.fromkeys(counters, 0)
        self.root = _Span(self, name)

    def __enter__(self):
        self.token = _current.set(self)
        self.root.__enter__()

    def __exit__(self, *exc):
        self.root.__exit__()
        _current.reset(self.token)
        _, _, t0, t1 = self.spans[0]
        self.stats["wall_s"] = (t1 - t0) / 1e9
        for key, name in self.sums.items():
            self.stats[key] = sum(b - a for n, _, a, b in self.spans
                                  if n == name) / 1e9
        self.stats["spans"] = [tuple(s) for s in self.spans]
        self.stats.update(self.counts)
        return False


def recording(name: str, stats: dict | None, counters=(), sums=None):
    """The context of an entry's body: records the call into `stats`,
    or nothing where `stats` is None."""
    if stats is None:
        return _OFF
    return _Recording(name, stats, counters, sums or {})


def span(name: str):
    """`with span(name):` records the block as a span when tracing."""
    rec = _current.get()
    return _OFF if rec is None else _Span(rec, name)


def on() -> bool:
    """Whether a recorder is current: guards a count whose value costs
    work to compute."""
    return _current.get() is not None


def count(name: str, n: int = 1):
    """Adds n to the counter `name` when tracing."""
    rec = _current.get()
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n
