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
FAIL`; hist8 computes the function its body means.  Times follow the
reference's chain_time (see there).  Result keys and units are the
reference script's.

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
CHAIN = 7                          # the reference's chain length


def _leg_ms(fn, dev: torch.device) -> float:
    """Time of fn() in ms, the device idle before it: CUDA events around
    it and a synchronize after on a CUDA device, else the host clock."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def chain_time(step, x0, dev: torch.device, reps: int = CHAIN) -> float:
    """Per-call ms of `step` by the reference scripts' method
    (research/radix_probe.py:41-57, chain_time): one warm call; then,
    twice, one call step(x0) timed alone and a dependent chain of `reps`
    calls (x = step(x) from x0, each output the next input) timed as a
    whole; per call = (chain - one) / (reps - 1), the best of the two.
    A step whose output cannot be its input ignores its argument, so
    its chain is step(x0) repeated, as the reference's sorts and Q3 legs
    are timed.  CUDA events on a CUDA device, else the host clock."""
    if reps < 2:
        raise ValueError("chain_time: reps must be >= 2")

    def chain():
        x = x0
        for _ in range(reps):
            x = step(x)

    step(x0)
    best = float("inf")
    for _ in range(2):
        one = _leg_ms(lambda: step(x0), dev)
        many = _leg_ms(chain, dev)
        best = min(best, (many - one) / (reps - 1))
    return best


def fixed_step(fn):
    """fn as a chain step that ignores its input."""
    return lambda _: fn()


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


def run(data: bytes, device=None, reps: int = CHAIN) -> dict:
    """P1-P5 on `data` (a whole multiple of 8192 * 128 bytes), each
    timed by chain_time with chains of `reps` calls; returns the
    reference script's result keys, times in ms (dma_per_copy_us in
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
        res[name + "_ms"] = chain_time(fixed_step(fn), None, dev, reps)

    # P2: gathers, each output the next call's x
    x = ins["x"]
    for r in GATHER_ROWS:
        res[f"gather_ax0_R{r}_ms"] = chain_time(
            lambda v, r=r: RC.gather_rows(v, ins["idx"][r], r), x, dev,
            reps)
    res["gather_ax1_ms"] = chain_time(
        lambda v: RC.gather_lanes(v, ins["idx_lanes"]), x, dev, reps)

    # P3: the count step
    res["hist256_ms"] = chain_time(fixed_step(lambda: RC.hist8(x)), None, dev,
                                   reps)

    # P4: run copies into a zeroed buffer (zeroed outside the timing)
    dst = torch.zeros_like(x)
    ms = chain_time(fixed_step(lambda: RC.run_copy(x, dst, ins["offs"],
                                               RUN_ROWS)), None, dev, reps)
    res["dma_2048x8KB_ms"] = ms
    res["dma_per_copy_us"] = ms / RUNS * 1e3

    # P5: compare-exchange stages, each output the next call's x
    ms = chain_time(RC.cmpex3, x, dev, reps)
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
    ap.add_argument("--reps", type=int, default=CHAIN,
                    help="calls in a timed chain (at least 2)")
    a = ap.parse_args(argv)
    print(json.dumps(run_fn(make_corpus(a.mib, SEED), a.device, a.reps)))


def main(argv=None) -> None:
    cli(run, argv)


if __name__ == "__main__":
    main()
