"""Probe the primitives a radix sort on the card would be built from.

Counterpart of research/radix_probe.py: can a hand-built counting sort
beat the library sort on the matcher's sort legs?  On the corpus's
first u32 chunk values (v0, int32, as [rows, 128]) it times:

  P1  torch.sort baselines: 1 key + 1 payload, 1 key + 3 payloads,
      2 keys (unsigned v0, v1) + 3 payloads
  P2  gather_rows: take_along_axis(axis=0) inside blocks of R = 1024,
      4096, 8192 rows, with seeded indices; gather_lanes: along the 128
      lanes of each row
  P3  hist8: per 2048-row tile and lane, the byte-digit histogram
      folded to 8 rows (the count step at B = 256)
  P4  run_copy: K = 2048 runs of C = 16 rows (8 KiB) at seeded offsets
      (the distribute step's copies)
  P5  cmpex3: three compare-exchange stages inside 2048-row tiles

The primitives are ops/radix_cuda.py's kernels (on CPU tensors their
plain versions).  The reference script's hist_kernel does not trace
under jax 0.9.0 (its `.reshape(1, 128)`), so it can only print `hist
FAIL`; hist8 computes the function its body means.  Each time is the
median of `reps` calls after a warm one: CUDA events on the card, the
host clock on the CPU.  Result keys are the reference script's.

    python -m brotli_tpu_torch.research.radix_probe            # the card
    python -m brotli_tpu_torch.research.radix_probe --device cpu --mib 1
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import radix_cuda as RC
from ..ops.fold_cuda import _sort_by_v0, _sort_by_v0v1
from ..ops.matching import as_i32, u32_values_at
from .corpus import SEED, make_corpus

LANES = RC.LANES
GATHER_ROWS = (1024, 4096, 8192)   # P2's rows per block
RUNS, RUN_ROWS = 2048, 16          # P4


def median_ms(fn, dev: torch.device, reps: int = 15) -> float:
    """Median wall time of `reps` calls of fn after one warm call, in ms:
    CUDA events around each call on a CUDA device, else the host clock."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def block_index(rows: int, high: int, seed: int,
                dev: torch.device) -> torch.Tensor:
    """int32 [rows, 128] in [0, high) from numpy's default_rng(seed), as
    the reference script draws its gather indices."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, high, size=(rows, LANES), dtype=np.int32)).to(dev)


def inputs(data: bytes, dev: torch.device) -> dict:
    """The probe's inputs on `dev`: the corpus's u32 chunk values at
    offsets 0 and 4 (v0u, v1u: int64 holding u32), x (v0 as int32
    [rows, 128]), the gather indices per R (idx) and along
    the lanes (idx_lanes), and P4's run offsets (offs), each from the
    reference script's seed."""
    n = len(data)
    if n % (max(GATHER_ROWS) * LANES):
        raise ValueError(f"radix_probe: {n} bytes is not a multiple of "
                         f"{max(GATHER_ROWS) * LANES}")
    rows = n // LANES
    raw = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    v0u = u32_values_at(raw, 0)
    offs = np.random.default_rng(3).integers(0, rows - RUN_ROWS,
                                             size=(RUNS,), dtype=np.int32)
    return dict(v0u=v0u, v1u=u32_values_at(raw, 4),
                x=as_i32(v0u).view(rows, LANES),
                idx={r: block_index(rows, r, 0 if r == 1024 else 1, dev)
                     for r in GATHER_ROWS},
                idx_lanes=block_index(rows, LANES, 2, dev),
                offs=torch.from_numpy(offs).to(dev))


def run(data: bytes, device=None, reps: int = 15) -> dict:
    """P1-P5 on `data` (a whole multiple of 8192 * 128 bytes); returns
    the reference script's result keys, times in ms (dma_per_copy_us in
    us).  device=None means CUDA and raises without it."""
    dev = resolve_device(device)
    ins = inputs(data, dev)
    v0u, v1u = ins["v0u"], ins["v1u"]
    v0 = as_i32(v0u)
    res = {}

    # P1: library sort baselines
    def sort_1k_1p():
        k, pos = _sort_by_v0(v0, [])
        return k ^ pos

    def sort_1k_3p():
        k, pos, _, _ = _sort_by_v0(v0, [v1u, v1u])
        return k ^ pos

    def sort_2k_3p():
        k, _, pos, _, _ = _sort_by_v0v1([v0u, v1u, v1u, v1u])
        return k ^ pos

    for name, fn in (("sort_1k_1p", sort_1k_1p), ("sort_1k_3p", sort_1k_3p),
                     ("sort_2k_3p", sort_2k_3p)):
        res[name + "_ms"] = median_ms(fn, dev, reps)

    # P2: gathers
    x = ins["x"]
    for r in GATHER_ROWS:
        res[f"gather_ax0_R{r}_ms"] = median_ms(
            lambda r=r: RC.gather_rows(x, ins["idx"][r], r), dev, reps)
    res["gather_ax1_ms"] = median_ms(
        lambda: RC.gather_lanes(x, ins["idx_lanes"]), dev, reps)

    # P3: the count step
    res["hist256_ms"] = median_ms(lambda: RC.hist8(x), dev, reps)

    # P4: run copies into a zeroed buffer (zeroed outside the timing)
    dst = torch.zeros_like(x)
    ms = median_ms(lambda: RC.run_copy(x, dst, ins["offs"], RUN_ROWS), dev,
                   reps)
    res["dma_2048x8KB_ms"] = ms
    res["dma_per_copy_us"] = ms / RUNS * 1e3

    # P5: compare-exchange stages
    ms = median_ms(lambda: RC.cmpex3(x), dev, reps)
    res["cmpex_3stage_ms"] = ms
    res["cmpex_per_stage_ms"] = ms / 3
    return res


def cli(run_fn, argv=None) -> None:
    """Command line of a probe: run `run_fn` on the seeded corpus and
    print its result as one JSON line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mib", type=int, default=5,
                    help="corpus MiB (seed 20261016); 5 is the probe's "
                         "N = 5,242,880")
    ap.add_argument("--reps", type=int, default=15)
    a = ap.parse_args(argv)
    print(json.dumps(run_fn(make_corpus(a.mib, SEED), a.device, a.reps)))


def main(argv=None) -> None:
    cli(run, argv)


if __name__ == "__main__":
    main()
