"""How the card's scripts time a kernel on one CUDA card.

  median_ms     CUDA events around one call, median of `reps` (the
                wrapper's host time included)
  device_ms     the kernel's own duration from torch.profiler's CUDA
                activity (CUPTI), median of 15 calls, the L2 flushed by a
                128 MiB fill of a scratch buffer before each call (its
                own kernel, outside the duration)
  busy_ms       the sum of the durations of every device activity (all
                kernels, copies, fills) of one call, median of 15 calls,
                the L2 flushed before each as for device_ms
  burst_ms      CUDA events around 50 back-to-back calls, over 50 (warm
                L2; the host's launch pace where it is the slower)
  host_us       host microseconds a call over 1,000 calls with no
                synchronize between them

chip_smoke.py and the A/B scripts of research/ read their times from
here.
"""

from __future__ import annotations

import time

import torch

FLUSH_BYTES = 128 << 20     # one write this large evicts the 50 MB L2
DEVICE_REPS, BURST, HOST_CALLS = 15, 50, 1000
LEAD_FLUSHES = 100          # device_ms: fills before the timed launches
TRACE_TRIES = 6             # traces taken before a timing gives up

_FLUSH = []


def median_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, kernel: str, reps: int = DEVICE_REPS,
              tries: int = TRACE_TRIES) -> float:
    """The median over `reps` calls of fn of the device duration (CUPTI
    kernel activity through torch.profiler) of the kernels whose name
    holds `kernel`, with the L2 flushed before each call by a 128 MiB
    fill of a scratch buffer (its own kernel, outside the duration).
    Traces of about a millisecond lost the kernels of their first half
    on an H100 (torch 2.11), so each trace opens with LEAD_FLUSHES fills
    (about 5 ms); a trace that holds a count of such kernels that is not
    a multiple of `reps` (some lost all of them, late in a long process)
    is logged and taken again, up to `tries` traces."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not _FLUSH:
        _FLUSH.append(torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                                  device="cuda"))
    flush = _FLUSH[0]
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_FLUSHES):   # the timed launches start late
                flush.fill_(-1)
            for i in range(reps):
                flush.fill_(i)
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and kernel in e.name),
                     key=lambda e: e.time_range.start)
        if evs and len(evs) % reps == 0:
            break
        print(f"device_ms: the trace holds {len(evs)} device kernels named "
              f"*{kernel}* for {reps} calls; tracing again", flush=True)
    else:
        raise AssertionError(f"device_ms: no complete trace of *{kernel}* "
                             f"in {tries} tries")
    per = len(evs) // reps
    times = sorted(sum(e.time_range.elapsed_us()
                       for e in evs[k * per:(k + 1) * per]) / 1e3
                   for k in range(reps))
    return times[reps // 2]


def _device_events(prof):
    from torch.autograd import DeviceType
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def busy_ms(fn, reps: int = DEVICE_REPS,
            tries: int = TRACE_TRIES) -> float:
    """The median over `reps` calls of fn of its device busy time: the
    sum of the CUPTI durations of all device activities of the call.
    Before each call the L2 is flushed by a 128 MiB int16 negation in
    place of a scratch buffer (a kernel the port never runs), which marks
    where a call's activities start; a trace whose calls do not all
    show the same number of activities is logged and taken again, up to
    `tries` traces."""
    from torch.profiler import ProfilerActivity, profile
    if not _FLUSH:
        _FLUSH.append(torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                                  device="cuda"))
    flush = _FLUSH[0].view(torch.int16)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_FLUSHES):
            flush.fill_(1)
        flush.neg_()
        torch.cuda.synchronize()
    marker = _device_events(prof)[-1].name
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_FLUSHES):
                flush.fill_(1)
            for _ in range(reps):
                flush.neg_()
                fn()
            torch.cuda.synchronize()
        calls = []
        for e in _device_events(prof):
            if e.name == marker:
                calls.append([])
            elif calls:
                calls[-1].append(e)
        if len(calls) == reps and len({len(c) for c in calls}) == 1 \
                and calls[0]:
            break
        print(f"busy_ms: the trace holds {len(calls)} calls of "
              f"{sorted({len(c) for c in calls})} activities for {reps} "
              "calls; tracing again", flush=True)
    else:
        raise AssertionError(f"busy_ms: no complete trace in {tries} tries")
    times = sorted(sum(e.time_range.elapsed_us() for e in c) / 1e3
                   for c in calls)
    return times[reps // 2]


def burst_ms(fn, n: int = BURST) -> float:
    """CUDA events around n back-to-back calls of fn, over n (warm L2,
    the host's launch pace included where it is the slower)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_us(fn, n: int = HOST_CALLS) -> float:
    """Host microseconds per call of fn over n calls with no synchronize
    between them (the device drained before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def device_times(fn, kernel: str) -> dict:
    return dict(device_ms=device_ms(fn, kernel), burst_ms=burst_ms(fn))
