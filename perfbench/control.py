#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, on the card, at a
cell's own size: the program's runs on each seed (the lower reading) and
the control's and the faults' (the upper), in one process so that the
set-up's builds are paid once.

  python3 perfbench/control.py --workload <cell> --seeds 1,2,3
      [--seconds 5] [--faults control,alter,unchanged,half]

Prints one JSON line a run: the seed, the fault (null for the program
as it is), `correct` and the numbers compared with their limits.  The
benchmark's own runs never plant a fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--faults", default="control")
    args = ap.parse_args(argv)
    sys.path[:] = [HERE, ROOT] + [p for p in sys.path if p not in (HERE, ROOT)]
    import torch
    import harness
    if not torch.cuda.is_available():
        harness.log("control: no CUDA card")
        return 2
    faults = [None] + [f for f in args.faults.split(",") if f]
    for seed in [int(s) for s in args.seeds.split(",")]:
        for fault in faults:
            r = harness.run(ROOT, args.workload, seed, args.seconds, False,
                            fault=fault)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": fault, "correct": r["correct"],
                              "attempted": r["attempted"],
                              "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
