"""Device tracing and kernel throughput counters.

Counterpart of brotli_tpu/utils/profiling.py: (a) a torch.profiler
trace scope that leaves a Chrome trace (open it in Perfetto or
chrome://tracing) and (b) per-kernel effective-throughput counters:
the best-of-N wall time of a call that ends in torch.cuda.synchronize
(a bare call returns before the card finishes), bytes moved supplied by
the caller, and on request the kernel's own device time from CUPTI
(research/devtime.py's device_ms).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace scope over the host and, where there is a
    card, its CUDA activity; on exit it writes trace_<pid>_<ns>.json,
    a Chrome trace, into `logdir` (made if missing).  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclass
class KernelStats:
    name: str
    wall_s: float        # best-of-N wall time of one call
    bytes_moved: int     # caller-declared device-memory traffic per call
    calls: int
    device_s: float | None = None   # the kernel's CUPTI time, if asked

    @property
    def gbps(self) -> float:
        return self.bytes_moved / self.wall_s / 1e9 if self.wall_s else 0.0

    def __str__(self) -> str:
        dev = "" if self.device_s is None \
            else f", device {self.device_s * 1e3:.4f} ms"
        return (f"[kernel] {self.name}: {self.wall_s * 1e3:.2f} ms, "
                f"{self.gbps:.2f} GB/s effective ({self.calls} calls"
                f"{dev})")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure_kernel(name: str, fn, args, bytes_moved: int,
                   warmup: int = 1, reps: int = 3,
                   kernel: str | None = None) -> KernelStats:
    """Best-of-`reps` wall time of fn(*args), each call ended by
    torch.cuda.synchronize() where CUDA is in use, after `warmup` calls.
    kernel: a substring of a kernel's name; then device_s is that
    kernel's device time (devtime.device_ms: CUPTI, the L2 flushed,
    median of 15 calls), which needs a card."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    stats = KernelStats(name=name, wall_s=best, bytes_moved=bytes_moved,
                        calls=warmup + reps)
    if kernel is not None:
        if not torch.cuda.is_available():
            raise RuntimeError("measure_kernel: a device time needs CUDA")
        from ..research.devtime import DEVICE_REPS, device_ms
        stats.device_s = device_ms(lambda: fn(*args), kernel) / 1e3
        stats.calls += 1 + DEVICE_REPS
    return stats
