"""Device time of this checkout's hist8 against an older build's, and of
its design choices.

    python -m brotli_tpu_torch.research.hist8_ab --old PATH

PATH is an older csrc/radix_probe.cu whose hist8 has the C interface
hist8_launch(x, out, rows, stream), as the first port's has: one CTA of
1024 threads a (tile, 32-lane group), one 4-byte load a thread before
each shared atomic.  Unpack the older commit into a directory that
.gitignore lists (git archive) and point PATH into it; the source is
built with nvcc for sm_90a beside the checkout's own.

On the radix probe's input (v0 of the 5 MiB seeded corpus as int32
[40960, 128]) and on the edge inputs of edge_inputs() at 1, 2 and 20
tiles, the old build and every build of the design sweep must equal
hist8_ref bit for bit.  Then device_ms (devtime.py: CUPTI duration, the
L2 flushed before each call, median of 15) in the order old, new, new,
old, with new = the wrapper; then each build of the source at every
cluster size (kHistCluster: 2, 4, 8), batch (rows' loads a thread keeps
in flight, kHistBatch) and load of LOADS, once.  Beside them: burst_ms
and host_us of both wrappers and of the host steps of a launch
(torch.empty, the current stream), and two yardsticks of reading the
same 21 MB: torch.sum(x) by device_ms, and the old, the new and the
16-load __ldg build by clean_ms, which flushes the L2 by reading a
buffer after the fill, so that no dirty line is left for the timed call
to write back.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..buildcache import BUILD_DIR, CudaLibrary
from ..ops import radix_cuda as RC
from .corpus import SEED, make_corpus
from .devtime import (DEVICE_REPS, FLUSH_BYTES, LEAD_FLUSHES, _device_events,
                      burst_ms, device_ms, host_us)
from .radix_probe import inputs

MIB = 5   # the probes' N = 5,242,880 bytes
CLUSTERS = (2, 4, 8)
SOURCE = (8, "__ldcs")   # the source's kHistBatch and load
# (rows' loads in flight a thread, load), each built at every cluster
# size: the source's own and the variants of it
LOADS = (SOURCE, (16, "__ldcs"), (8, "__ldg"), (16, "__ldg"), (32, "__ldg"))


def edge_inputs(tiles: int, seed: int = 7) -> dict:
    """int32 [2048 * tiles, 128] inputs at hist8's edges: one digit
    filling every tile (a count of 2048 in one output row), negative
    values (the low byte of a two's complement word), every digit once
    a lane and tile (the rest of the tile one digit), and seeded words."""
    rows = 2048 * tiles
    rng = np.random.default_rng(seed + tiles)
    every = np.full((tiles, 2048, 128), 0x55, np.int64)
    every[:, :256, :] = np.arange(256)[None, :, None] + (np.arange(128) << 8)
    return {
        "one_digit": np.full((rows, 128), 0x1234_5603, np.int64),
        "negative": rng.integers(-(1 << 31), 0, size=(rows, 128)),
        "every_digit": every.reshape(rows, 128),
        "seeded": rng.integers(-(1 << 31), 1 << 31, size=(rows, 128)),
    }


def _bind_old(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hist8_launch.argtypes = [vp, vp, ci, vp]
    lib.hist8_launch.restype = ci


def old_hist8(src: str, lib=None):
    """The build of `src`'s hist8 (or `lib`, a CudaLibrary of it bound
    by RC._bind) on a CUDA int32 [rows, 128] tensor."""
    lib = (lib or CudaLibrary("radix_probe_old", _bind_old, src=src)).get()

    def run(x):
        out = torch.empty((8 * x.shape[0] // 2048, 128), dtype=torch.int32,
                          device=x.device)
        err = lib.hist8_launch(x.data_ptr(), out.data_ptr(), x.shape[0],
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"hist8 of {src}: CUDA error {err}")
        return out

    return run


def _variant_source(batch: int, load: str, cluster: int) -> str:
    """csrc/radix_probe.cu with kHistBatch = batch, kHistCluster =
    cluster and hist8's loads by `load` (__ldg or __ldcs, cache-streaming:
    evict-first in L1 and L2), written under the build directory;
    returns its path."""
    with open(RC.LIB.src) as f:
        src = f.read()
    for old, new in ((f"constexpr int kHistBatch = {SOURCE[0]};",
                      f"constexpr int kHistBatch = {batch};"),
                     (f"constexpr int kHistCluster = {RC.HIST8_CLUSTER};",
                      f"constexpr int kHistCluster = {cluster};"),
                     (f"{SOURCE[1]}(src", f"{load}(src")):
        if old not in src:
            raise AssertionError(f"hist8_ab: {old!r} not in the source")
        src = src.replace(old, new)
    path = os.path.join(BUILD_DIR, "sweep",
                        f"radix_probe_b{batch}{load}_c{cluster}.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path


def clean_ms(fn, reps: int = DEVICE_REPS) -> float:
    """The median over `reps` calls of fn of the CUPTI durations of its
    device activities, each call after a 128 MiB write (an int16
    negation in place, which marks where a call starts) and a read of
    another 128 MiB buffer (a sum), so the L2 holds clean lines only:
    what the call takes when it has no dirty line of the flush to write
    back.  The sum's own activities are counted in a trace of its own
    and skipped."""
    from torch.profiler import ProfilerActivity, profile
    a = torch.empty(FLUSH_BYTES // 2, dtype=torch.int16, device="cuda")
    b = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_FLUSHES):
            a.fill_(1)
        a.neg_()
        torch.cuda.synchronize()
    marker = _device_events(prof)[-1].name

    def split(call):
        """Each call's activities after its flush, the sum's included."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_FLUSHES):
                a.fill_(1)
            for _ in range(reps):
                a.neg_()
                b.sum()
                call()
            torch.cuda.synchronize()
        calls = []
        for e in _device_events(prof):
            if e.name == marker:
                calls.append([])
            elif calls:
                calls[-1].append(e)
        if len(calls) != reps or len({len(c) for c in calls}) != 1:
            raise AssertionError("clean_ms: the trace is not one call "
                                 f"after each of {reps} flushes")
        return calls

    n_read = len(split(_nothing)[0])
    fn()
    torch.cuda.synchronize()
    times = sorted(sum(e.time_range.elapsed_us() for e in c[n_read:]) / 1e3
                   for c in split(fn))
    return times[reps // 2]


def _nothing():
    pass


def run(old_src: str) -> dict:
    dev = torch.device("cuda", 0)
    variants = {f"b{b}{ld} cluster{c}": CudaLibrary(
        f"radix_probe_b{b}{ld}_c{c}", RC._bind, src=_variant_source(b, ld, c))
        for b, ld in LOADS for c in CLUSTERS
        if (b, ld) != SOURCE or c != RC.HIST8_CLUSTER}
    with ThreadPoolExecutor(len(variants) + 1) as ex:
        for f in [ex.submit(lib.build) for lib in
                  [*variants.values(), RC.LIB]]:
            f.result()
    fns = {"old": old_hist8(old_src), "new": RC.hist8}
    fns.update({name: old_hist8(lib.src, lib) for name, lib in
                variants.items()})
    x = inputs(make_corpus(MIB, SEED), dev)["x"]
    cases = [("probe", x)] + [
        (f"{name} x{t}", torch.from_numpy(v.astype(np.int32)).to(dev))
        for t in (1, 2, 20) for name, v in edge_inputs(t).items()]
    for name, xc in cases:
        want = RC.hist8_ref(xc)
        for build, fn in fns.items():
            if not torch.equal(fn(xc), want):
                raise AssertionError(f"hist8 {name}: {build} != hist8_ref")
    print(f"hist8: every build equal to hist8_ref on {len(cases)} inputs",
          flush=True)
    got = {"old": [], "new": []}
    for build in ("old", "new", "new", "old"):
        got[build].append(device_ms(lambda: fns[build](x), "hist8"))
    designs = {name: device_ms(lambda: fn(x), "hist8")
               for name, fn in fns.items() if " cluster" in name}
    designs[f"b{SOURCE[0]}{SOURCE[1]} cluster{RC.HIST8_CLUSTER}"] = \
        device_ms(lambda: fns["new"](x), "hist8")
    mean = {b: sum(v) / len(v) for b, v in got.items()}
    idx = x.device.index
    res = dict(old_device_ms=got["old"], new_device_ms=got["new"],
               old_over_new=mean["old"] / mean["new"],
               design_device_ms=designs,
               sum_device_ms=device_ms(lambda: x.sum(), "reduce"),
               clean_ms={k: clean_ms(lambda: fns[k](x)) for k in (
                   "old", "new", f"b16__ldg cluster{RC.HIST8_CLUSTER}")},
               old_burst_ms=burst_ms(lambda: fns["old"](x)),
               new_burst_ms=burst_ms(lambda: fns["new"](x)),
               old_host_us=host_us(lambda: fns["old"](x)),
               new_host_us=host_us(lambda: fns["new"](x)),
               empty_host_us=host_us(lambda: torch.empty(
                   (160, 128), dtype=torch.int32, device=x.device)),
               new_empty_host_us=host_us(lambda: x.new_empty((160, 128))),
               stream_host_us=host_us(
                   lambda: torch.cuda.current_stream().cuda_stream),
               raw_stream_host_us=host_us(
                   lambda: torch._C._cuda_getCurrentRawStream(idx)),
               plan=RC.hist8_plan(x.shape[0]))
    print(f"hist8: device ms old {got['old']}, new {got['new']}, old / new "
          f"{res['old_over_new']:.3f}; designs {designs}", flush=True)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="an older csrc/radix_probe.cu (see the docstring)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hist8_ab: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(json.dumps({"hist8_ab": run(a.old)}), flush=True)


if __name__ == "__main__":
    main()
