"""Device time of this checkout's gathers against an older build's.

    python -m brotli_tpu_torch.research.gather_ab --old PATH

PATH is an older csrc/radix_probe.cu whose gathers have the first
port's C interface, gather_rows_launch(x, idx, out, rows,
rows_per_block, stream) and gather_lanes_launch(x, idx, out, rows,
stream): one element a thread, x read where idx points.  Unpack the
older commit into a directory that .gitignore lists (git archive) and
point PATH into it; the source is built with nvcc for sm_90a beside the
checkout's own.

On the radix probes' input (v0 of the 5 MiB seeded corpus as int32
[40960, 128], the probes' seeded indices) each gather site, gather_rows
at R = 8, 32, 256 (radix_probe2.py) and 1024, 4096, 8192
(radix_probe.py) and gather_lanes, is first held against its plain
version for both builds, bit for bit.  Then its device_ms (devtime.py:
CUPTI duration, the L2 flushed before each call, median of 15) is taken
in the order old, new, new, old.  Prints the card's name and power
limit, then one JSON line: per site both readings of each build and
old / new of their means.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from ..buildcache import CudaLibrary
from ..ops import radix_cuda as RC
from .corpus import SEED, make_corpus
from .devtime import device_ms
from .radix_probe import GATHER_ROWS, block_index, inputs
from .radix_probe2 import GATHER_ROWS as GATHER_ROWS2

MIB = 5   # the probes' N = 5,242,880 bytes


def _bind_old(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gather_rows_launch.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.gather_lanes_launch.argtypes = [vp, vp, vp, ci, vp]
    lib.gather_rows_launch.restype = ci
    lib.gather_lanes_launch.restype = ci


def old_gathers(src: str):
    """(gather_rows, gather_lanes) of the build of `src`, on CUDA
    tensors of the wrappers' shapes."""
    lib = CudaLibrary("radix_probe_old", _bind_old, src=src).get()

    def call(fn, x, idx, *extra):
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
                 *extra, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old gather: CUDA error {err}")
        return out

    return (lambda x, idx, r: call(lib.gather_rows_launch, x, idx, r),
            lambda x, idx: call(lib.gather_lanes_launch, x, idx))


def sites(dev: torch.device) -> list:
    """(name, x, idx, R or None for gather_lanes) at the probes' inputs."""
    ins = inputs(make_corpus(MIB, SEED), dev)
    x = ins["x"]
    rows = x.shape[0]
    out = [(f"gather_rows R={r}", x, block_index(rows, r, r, dev), r)
           for r in GATHER_ROWS2]
    out += [(f"gather_rows R={r}", x, ins["idx"][r], r) for r in GATHER_ROWS]
    out.append(("gather_lanes", x, ins["idx_lanes"], None))
    return out


def run(old_src: str) -> dict:
    dev = torch.device("cuda", 0)
    old_rows, old_lanes = old_gathers(old_src)
    res = {}
    for name, x, idx, r in sites(dev):
        if r is None:
            fns = dict(old=lambda: old_lanes(x, idx),
                       new=lambda: RC.gather_lanes(x, idx))
            want, kernel = RC.gather_lanes_ref(x, idx), "gather_lanes"
        else:
            fns = dict(old=lambda: old_rows(x, idx, r),
                       new=lambda: RC.gather_rows(x, idx, r))
            want, kernel = RC.gather_rows_ref(x, idx, r), "gather_rows"
        for build, fn in fns.items():
            if not torch.equal(fn(), want):
                raise AssertionError(f"{name}: the {build} build != plain")
        got = {"old": [], "new": []}
        for build in ("old", "new", "new", "old"):
            got[build].append(device_ms(fns[build], kernel))
        mean = {b: sum(v) / len(v) for b, v in got.items()}
        res[name] = dict(old_device_ms=got["old"], new_device_ms=got["new"],
                         old_over_new=mean["old"] / mean["new"])
        print(f"{name}: device ms old {got['old']}, new {got['new']}, "
              f"old / new {mean['old'] / mean['new']:.3f}", flush=True)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="an older csrc/radix_probe.cu (see the docstring)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_ab: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(json.dumps({"gather_ab": run(a.old)}), flush=True)


if __name__ == "__main__":
    main()
