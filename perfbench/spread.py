#!/usr/bin/env python3
"""Run one cell several times, a new process a run, and report each
metric's median and spread: the distance between the first and third
quartiles (statistics.quantiles(values, n=4)) as a share of the median.

  python3 perfbench/spread.py --workload <cell> --seeds 1,2,3
      [--seconds 30] [--trace 0] [--out FILE.jsonl]

Each run's result line, its wall time and the lines it printed before
the result (the inputs' sha256) are appended to FILE.jsonl.
The bound of an end-to-end metric is set from the wider spread of two
such sets of 6 runs on the same seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values) -> float:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    runs = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines() or [""]
        line = lines[-1]
        try:
            res = json.loads(line)
        except json.JSONDecodeError:
            res = None
        rec = {"workload": args.workload, "seed": seed, "rc": p.returncode,
               "wall_s": wall, "result": res,
               "stdout_head": "\n".join(lines[:-1])[-2000:],
               "stderr_tail": p.stderr[-1500:]}
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        runs.append(rec)
        m = res["metrics"] if res else {}
        print(f"seed {seed} rc {p.returncode} wall {wall:.1f} correct "
              f"{res and res['correct']} attempted {res and res['attempted']}"
              f" " + " ".join(f"{k}={v['value']:.6g}" for k, v in m.items()),
              flush=True)
        if res is None:
            print(p.stderr[-3000:], flush=True)
    good = [r["result"] for r in runs if r["result"]]
    names = sorted({k for r in good for k in r["metrics"]})
    for k in names:
        vals = [r["metrics"][k]["value"] for r in good if k in r["metrics"]]
        if len(vals) >= 2:
            print(f"{k}: n {len(vals)} median {statistics.median(vals):.6g}"
                  f" spread {spread(vals):.6f} min {min(vals):.6g} max "
                  f"{max(vals):.6g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
