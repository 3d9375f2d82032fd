"""The traced run's device trace: torch.profiler with CUDA activity
(CUPTI) over the window, read back as device activity intervals.

A `spin_kernel` marker (torch.cuda._sleep) is launched after a
synchronize at each end of the window.  The window in trace time runs
from the end of the first marker to the start of the second; host
times (perf_counter) map onto trace time through the first marker's
launch.  Traces on an H100 (torch 2.11) have lost the device events of
their first moments, so the first marker follows LEAD_FILLS small fills
(as devtime.py's LEAD_FLUSHES); where one marker is lost all the same,
the window's other end is placed by the host clock's distance between
the two marks.  Method after brotli_tpu_torch/research/devtime.py: CUPTI
through torch.profiler, the raw kineto events read (not the profiler's
Python event list, which is slow on tens of thousands of events).
"""

from __future__ import annotations

import sys
import time

import torch

MARKER = "spin_kernel"
MARKER_CYCLES = 20000
LEAD_FILLS = 200


class DeviceTrace:
    """Device activity inside the window: `events` lists (name, start
    ns, end ns) clipped to the window, `t0`/`t1` the window in trace
    ns, `host0` the host perf_counter time of trace ns `t0_host`."""

    def __init__(self, events, t0, t1, t0_host, host0):
        self.events = events
        self.t0, self.t1 = t0, t1
        self.t0_host, self.host0 = t0_host, host0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list:
        out = []
        for _, a, b in sorted(self.events, key=lambda e: e[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> list:
        """(start ns, end ns) of each stretch in the window in which no
        device activity ran."""
        gaps, at = [], self.t0
        for a, b in self.busy_intervals():
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def to_host(self, t_ns: float) -> float:
        """The host perf_counter time of trace time t_ns."""
        return self.host0 + (t_ns - self.t0_host) / 1e9

    def kernels(self, name: str) -> list:
        """(start ns, end ns) of the kernels whose name holds `name`, in
        order of start."""
        return sorted((a, b) for n, a, b in self.events if name in n)


def window_of(marks, first: int, span_ns: float):
    """(first marker's start, window start, window end) in trace ns from
    the markers found, (start, end) each, the trace's first event and
    the host clock's distance between the two marks."""
    if len(marks) == 2:
        (m0a, t0), (t1, _) = marks
        return m0a, t0, t1
    if len(marks) != 1:
        raise RuntimeError(f"devtrace: {len(marks)} of 2 markers in the "
                           "trace")
    (a, b), = marks
    print("devtrace: one marker of two in the trace; the window's other "
          f"end placed by the host clock ({span_ns / 1e9:.3f} s)",
          file=sys.stderr)
    if a - first < span_ns / 2:     # the first marker: the end was lost
        return a, b, a + span_ns
    return a - span_ns, a - span_ns + (b - a), a


class Tracer:
    """`with Tracer() as tr:` around the window, with `tr.mark()` where
    the window starts and again where it ends; `tr.read()` after the
    block."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.host_marks = []

    def __enter__(self):
        self.prof.__enter__()
        lead = torch.empty(1 << 16, dtype=torch.int32, device="cuda")
        for i in range(LEAD_FILLS):
            lead.fill_(i)
        torch.cuda.synchronize()
        return self

    def mark(self):
        """A marker kernel after the device has drained; returns the
        host time of its launch."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        self.host_marks.append(t)
        torch.cuda.synchronize()
        return t

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def read(self) -> DeviceTrace:
        """The window's device activity; raises where the markers are
        not in the trace."""
        from torch.autograd import DeviceType
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            a = e.start_ns()
            raw.append((e.name(), a, a + e.duration_ns()))
        marks = sorted((a, b) for n, a, b in raw if MARKER in n)
        h0, h1 = self.host_marks
        first = min((e[1] for e in raw), default=0)
        m0a, t0, t1 = window_of(marks, first, (h1 - h0) * 1e9)
        events = [(n, max(a, t0), min(b, t1)) for n, a, b in raw
                  if MARKER not in n and b > t0 and a < t1]
        return DeviceTrace(events, t0, t1, m0a, h0)
