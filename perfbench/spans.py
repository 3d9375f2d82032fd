"""Span wrappers around the program's module attributes (traced runs
only) and the interval arithmetic the layer readers share.

A wrap point is "package.module:attr" or "package.module:Class.attr":
an attribute the program looks up when it calls it, so replacing it on
its module or class puts a span around every call.  Each call records
(t0, t1, recs) on the host's perf_counter clock, where recs holds what
the readers' record functions took from its arguments and result.
Untraced runs install nothing: the program runs unpatched.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import time


class Span:
    __slots__ = ("t0", "t1", "recs")

    def __init__(self, t0, t1, recs):
        self.t0, self.t1, self.recs = t0, t1, recs


def _resolve(point: str):
    """(owner, attr name, current value) of a wrap point; raises
    LookupError with the reason where it does not exist."""
    mod_name, _, path = point.partition(":")
    try:
        owner = importlib.import_module(mod_name)
    except ImportError as e:
        raise LookupError(f"module {mod_name} does not import ({e})")
    *outer, attr = path.split(".")
    for name in outer:
        if not hasattr(owner, name):
            raise LookupError(f"{mod_name} has no {name}")
        owner = getattr(owner, name)
    if not callable(getattr(owner, attr, None)):
        raise LookupError(f"{point} is not a callable attribute")
    return owner, attr, inspect.getattr_static(owner, attr)


class Wraps:
    """Installed wrappers: `spans[point]` lists the calls recorded since
    the last `clear()`; `missing[point]` says why a point could not be
    wrapped.  `restore()` puts the program back as it was."""

    def __init__(self):
        self.spans: dict = {}
        self.missing: dict = {}
        self._records: dict = {}
        self._undo = []
        self.recording = False

    def install(self, point: str, records=()):
        """Wrap `point`; `records` lists (key, fn) where fn(bound
        arguments, result) returns what to keep for reader `key`."""
        if point in self.missing:
            return
        if point in self.spans:
            self._records[point].extend(records)
            return
        try:
            owner, attr, raw = _resolve(point)
        except LookupError as e:
            self.missing[point] = str(e)
            return
        fn = getattr(owner, attr)
        is_static = isinstance(raw, staticmethod)
        sig = inspect.signature(fn)
        spans = self.spans[point] = []
        recs_of = self._records[point] = list(records)
        wraps = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not wraps.recording:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            t1 = time.perf_counter()
            recs = None
            if recs_of:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                recs = {key: rec(bound.arguments, result)
                        for key, rec in recs_of}
            spans.append(Span(t0, t1, recs))
            return result

        setattr(owner, attr, staticmethod(wrapper) if is_static else wrapper)
        self._undo.append((owner, attr, raw))

    def clear(self):
        for spans in self.spans.values():
            spans.clear()

    def restore(self):
        self.recording = False
        for owner, attr, raw in reversed(self._undo):
            setattr(owner, attr, raw)
        self._undo.clear()


def union(intervals) -> list:
    """The union of (t0, t1) intervals as sorted disjoint intervals."""
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1][1] = t1
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def length(intervals) -> float:
    """The time the union of the intervals covers."""
    return sum(b - a for a, b in union(intervals))


def inside(intervals, within) -> float:
    """The time the union of `intervals` covers inside the union of
    `within`."""
    a = union(intervals)
    b = union(within)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def intervals(spans) -> list:
    return [(s.t0, s.t1) for s in spans]
