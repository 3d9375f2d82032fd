"""Follow-ups to the radix probe: small-block gathers, segmented sorts
and the exact9 matcher leg by leg.

Counterpart of research/radix_probe2.py, on the card:

  Q1  gather_rows (ops/radix_cuda.py) inside blocks of R = 8, 32, 256
      rows, with seeded indices
  Q2  segmented sorts: torch.sort(dim=1, stable=True) of v0 as
      [8, N / 8] and [64, N / 64], with the row positions as payload
  Q3  the q9 matcher's legs: the chunk-value build (prep), the two-key
      (unsigned v0, v1) sort with 3 payloads (sort8) and its fold
      (fold8: 2 keys, 2 payloads, 16/8), the one-key sort with 1
      payload (sort_short) and its fold (fold_short: 16/0), and the
      whole best_matches_exact9_p(invert=False)

Times as in radix_probe.py (the reference's chain_time: chains of
`reps` calls less one call, best of 2; CUDA events on the card, the
host clock on the CPU); result keys are the reference script's.

    python -m brotli_tpu_torch.research.radix_probe2            # the card
    python -m brotli_tpu_torch.research.radix_probe2 --device cpu --mib 1
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import radix_cuda as RC
from ..ops.fold_cuda import (_sort_by_v0, _sort_by_v0v1,
                             best_matches_exact9_p, fold_sorted)
from ..ops.matching import as_i32, u32_values_at
from .radix_probe import (CHAIN, LANES, block_index, chain_time, cli,
                          fixed_step)

GATHER_ROWS = (8, 32, 256)   # Q1's rows per block, each its own seed
SEGMENTS = (8, 64)           # Q2
WINDOW = (1 << 22) - 16      # Q3's window (lgwin 22)
FOLD = dict(min_pos=0, window=WINDOW, lbs=135, len_shift=26)


def run(data: bytes, device=None, reps: int = CHAIN) -> dict:
    """Q1-Q3 on `data` (a whole multiple of 256 * 128 bytes), each timed
    by chain_time with chains of `reps` calls; returns the reference
    script's result keys, times in ms.  device=None means CUDA and
    raises without it."""
    dev = resolve_device(device)
    n = len(data)
    if n % (max(GATHER_ROWS) * LANES):
        raise ValueError(f"radix_probe2: {n} bytes is not a multiple of "
                         f"{max(GATHER_ROWS) * LANES}")
    rows = n // LANES
    raw = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    vu = [u32_values_at(raw, 4 * r) for r in range(4)]
    v0 = as_i32(vu[0])
    res = {}

    # Q1: axis-0 gathers in small blocks
    x = v0.view(rows, LANES)
    for r in GATHER_ROWS:
        idx = block_index(rows, r, r, dev)
        res[f"gather_ax0_R{r}_ms"] = chain_time(
            lambda v, r=r, idx=idx: RC.gather_rows(v, idx, r), x, dev, reps)

    # Q2: segmented sorts, positions in the segment as payload
    for seg in SEGMENTS:
        xs = v0.view(seg, n // seg)

        def seg_sort(xs=xs):
            k, pos = torch.sort(xs, dim=1, stable=True)
            return k ^ pos.to(torch.int32)
        res[f"segsort_{seg}x{n // seg // 1024}K_ms"] = chain_time(
            fixed_step(seg_sort), None, dev, reps)

    # Q3: the exact9 legs
    def prep():
        return (u32_values_at(raw, 0) ^ u32_values_at(raw, 4)
                ^ u32_values_at(raw, 8) ^ u32_values_at(raw, 12))

    def sort8():
        return _sort_by_v0v1(vu)

    def sort_short():
        return _sort_by_v0(v0, [vu[1]])

    ops8, opss = sort8(), sort_short()

    def fold8():
        p, s = fold_sorted(ops8, n_keys=2, k_fwd=16, k_back=8, n_real=n,
                           **FOLD)
        return p ^ s

    def fold_short():
        p, s = fold_sorted(opss, n_keys=1, k_fwd=16, k_back=0, n_real=n,
                           **FOLD)
        return p ^ s

    def whole_exact9():
        r = best_matches_exact9_p(raw, WINDOW, k=16, k_short=16, rounds=4,
                                  invert=False)
        return r[1] ^ r[4]

    for name, fn in (("leg_prep", prep), ("leg_sort8", sort8),
                     ("leg_fold8", fold8), ("leg_sort_short", sort_short),
                     ("leg_fold_short", fold_short),
                     ("whole_exact9", whole_exact9)):
        res[name + "_ms"] = chain_time(fixed_step(fn), None, dev, reps)
    return res


def main(argv=None) -> None:
    cli(run, argv)


if __name__ == "__main__":
    main()
