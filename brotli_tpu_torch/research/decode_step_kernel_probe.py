"""Price the per-lane table read of a batch-decode step on the card.

Counterpart of research/decode_step_kernel_probe.py: 128 lanes, each
with its own table row ((128, 1056) int32, arange % 997), run STEPS
steps of an LCG on their state with 0, 1 or 2 dependent reads from
their row a step (ops/decode_gpu.step_probe: the rows in shared memory,
one lane a warp, on the CUDA kernel's grid; on CPU tensors the plain
version).  It prints the reference's keys:

  P3_vector_only  no read: the step's own cost
  P1_one_read     one read a step (the root-table lookup)
  P2_two_reads    two reads a step (lookup + refill)

each with us_per_step and, where it reads, est_MBps_128lanes (128 lanes
at the reference's 1.8 bytes a symbol, one symbol a step).  Times are
the reference's chain_time (reps calls chained output to input, less
one call, over reps - 1, best of 2), with a CUDA synchronize where the
reference converts to numpy; unlike the reference they are not rounded.

    python -m brotli_tpu_torch.research.decode_step_kernel_probe
    python -m brotli_tpu_torch.research.decode_step_kernel_probe --device cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import decode_gpu as D

LANES = 128
STEPS = 2048
WIDTH = 1056
BYTES_PER_SYMBOL = 1.8      # the reference's q2-grade streams
PROBES = (("P3_vector_only", 0), ("P1_one_read", 1), ("P2_two_reads", 2))


def chain_time(step, x0, reps=5, sync=lambda x: None,
               clock=time.perf_counter):
    """Seconds a call of `step` by the reference's method
    (research/decode_step_kernel_probe.py:43-58): one warm call; then,
    twice, one call step(x0) timed alone and a chain of `reps` calls
    (x = step(x) from x0) timed as a whole; per call = (chain - one) /
    (reps - 1), the best of the two.  `sync(x)` waits for x (the
    reference reads it back to numpy)."""
    x = step(x0)
    sync(x)
    best = float("inf")
    for _ in range(2):
        t0 = clock()
        x = step(x0)
        sync(x)
        t1 = clock()
        x = x0
        for _ in range(reps):
            x = step(x)
        sync(x)
        t2 = clock()
        best = min(best, ((t2 - t1) - (t1 - t0)) / (reps - 1))
    return best


def inputs(dev: torch.device):
    """The reference's table (LANES, WIDTH) and start state (1, LANES)."""
    tab = np.arange(LANES * WIDTH, dtype=np.int32).reshape(LANES, WIDTH)
    tab = torch.from_numpy(tab % 997).to(dev)
    st0 = torch.arange(LANES, dtype=torch.int32, device=dev)[None, :]
    return tab, st0


def run(device=None, reps: int = 5, steps: int = STEPS) -> dict:
    """P3, P1, P2 on `device` (None: CUDA, raises without it); returns
    the reference's result dict."""
    if reps < 2:
        raise ValueError("decode_step_kernel_probe: reps must be >= 2")
    dev = resolve_device(device)
    tab, st0 = inputs(dev)
    sync = (lambda x: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda x: None)
    results = {}
    for name, reads in PROBES:
        dt = chain_time(lambda s, r=reads: D.step_probe(tab, s, steps, r),
                        st0, reps, sync)
        per_step = dt / max(steps, 1)
        results[name] = dict(us_per_step=per_step * 1e6)
        if reads:
            results[name]["est_MBps_128lanes"] = (
                LANES * BYTES_PER_SYMBOL / per_step / 1e6 if per_step
                else float("inf"))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--reps", type=int, default=5,
                    help="calls in a timed chain (at least 2)")
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="steps a call (the reference's 2048)")
    a = ap.parse_args(argv)
    res = run(a.device, a.reps, a.steps)
    for name, _ in PROBES:
        print(name, res[name], flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
