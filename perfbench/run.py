#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

from the root of a checkout.  --trace 0 prints the cell's end-to-end
metrics with the program unpatched; --trace 1 its per-layer metrics,
from span wrappers and a torch.profiler trace of the window.  The last
line of standard output is one JSON object (correct, attempted, failed,
metrics, device[, breakdown], checks); the last lines of standard error
give each number the reference compared, beside its limit.

Exits 2 without a result where there is no CUDA card, or fewer than the
cell asks for, and 3 where a module of JAX or of the JAX package is
loaded once the window has closed.  Every build and kernel cache stays
inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "brotli_tpu")
CACHE = os.path.join(ROOT, ".perfbench_cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    # the harness's modules first, then the program at the checkout's root
    sys.path[:] = [HERE, ROOT] + [p for p in sys.path if p not in (HERE, ROOT)]
    import harness
    t_process = harness.process_start()
    cell = harness.Cell(ROOT, args.workload)
    chips = int(cell.workload["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"run: the cell needs {chips} CUDA card(s); this machine "
                  f"has {torch.cuda.device_count()} "
                  f"(available: {torch.cuda.is_available()}); no result")
        return 2
    from rooflines.peaks import peak
    name = torch.cuda.get_device_name()
    print(f"card {card_line()}; peaks {peak(name)} (at 700 W)", flush=True)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace), t_process=t_process)
    bad = forbidden_modules()
    if bad:
        harness.log(f"run: modules of JAX or the JAX package are loaded: {bad};"
                  " no result")
        return 3
    for k, c in result["checks"].items():
        rule, lim = next((r, v) for r, v in c.items() if r != "value")
        harness.log(f"check {k} {c['value']} {rule} {lim}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
