"""Device time of the design choices of two kernels, on the card.

    python -m brotli_tpu_torch.research.design_sweep

match_rounds (csrc/match_rounds.cu): the source is built again with
other values of its constants TWO_BATCH, FOLD_BATCH (rounds loaded as
one batch by the two-operand and the fold form) and THREADS (a CTA),
each build held to the plain versions bit for bit, then timed by its
device ms (devtime.device_ms) on chip_smoke.py's inputs: the first 4 MiB
shard of the seeded corpus in the h4 and h8 hash orders
(match_rounds_ab.sorted_rounds); the two-operand form at j = 1 and the
fold form at k = 2 (h4) and k = 1 (h8).  Beside them, what reading the
whole 128 MiB operand costs: a torch copy of it and a sum over its
rounds (devtime.busy_ms).

step_probe (csrc/decode_step.cu): the probe's shape (128 lanes x 2048
steps, decode_step_kernel_probe.inputs) launched with 1, 2, 4 and 8
lanes a CTA in place of step_probe_plan's choice, each held to
step_probe_ref, by device ms.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..buildcache import BUILD_DIR, CudaLibrary
from ..ops import decode_gpu as D
from ..ops import match_rounds_cuda as MR
from . import decode_step_kernel_probe as P
from .corpus import SEED, make_corpus
from .devtime import busy_ms, device_ms
from .match_rounds_ab import CORPUS_MIB, FOLDS, SHARD, sorted_rounds

# (TWO_BATCH, FOLD_BATCH, THREADS); the first is the source's own
MR_VARIANTS = ((2, 4, 128), (1, 1, 128), (2, 2, 128), (3, 3, 128),
               (4, 8, 128), (2, 4, 64), (2, 4, 256))
PROBE_LANES_PER_CTA = (1, 2, 4, 8)


def _variant_source(two: int, fold: int, threads: int) -> str:
    """csrc/match_rounds.cu with these constants, written under the
    build directory; returns its path."""
    with open(MR.LIB.src) as f:
        src = f.read()
    for old, new in (
            ("constexpr int TWO_BATCH = 2, FOLD_BATCH = 4;",
             f"constexpr int TWO_BATCH = {two}, FOLD_BATCH = {fold};"),
            (f"constexpr int THREADS = {MR.THREADS};",
             f"constexpr int THREADS = {threads};")):
        if old not in src:
            raise AssertionError(f"design_sweep: {old!r} not in the source")
        src = src.replace(old, new)
    path = os.path.join(BUILD_DIR, "sweep",
                        f"match_rounds_t{two}f{fold}x{threads}.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path


def match_rounds_sweep(dev: torch.device) -> dict:
    libs = {v: CudaLibrary(f"match_rounds_t{v[0]}f{v[1]}x{v[2]}", MR._bind,
                           src=_variant_source(*v)) for v in MR_VARIANTS}
    with ThreadPoolExecutor(min(8, len(libs))) as ex:
        for f in [ex.submit(lib.build) for lib in libs.values()]:
            f.result()
    shard = torch.from_numpy(np.frombuffer(
        make_corpus(CORPUS_MIB, SEED)[:SHARD], np.uint8).copy()).to(dev)
    ops = sorted_rounds(shard)
    va = ops["h4"]
    vb = MR.shift_rounds(va, 1)
    rounds, m = va.shape
    want = {"two_operand": MR.match_rounds_ref(va, vb)}
    for name, k in FOLDS:
        want[f"{name} k={k}"] = MR.match_rounds_shifted_ref(ops[name], k)
    res = {}
    for (two, fold, threads), cl in libs.items():
        lib = cl.get()
        ctas = -(-m // threads)
        stream = torch.cuda.current_stream().cuda_stream

        def run_two():
            out = torch.empty(m, dtype=torch.int32, device=dev)
            if lib.match_rounds_launch(va.data_ptr(), vb.data_ptr(),
                                       out.data_ptr(), rounds, m, threads,
                                       ctas, stream):
                raise RuntimeError("design_sweep: launch failed")
            return out

        def run_fold(name, k):
            x = ops[name]
            out = torch.empty((k, m), dtype=torch.int32, device=dev)
            if lib.match_rounds_shifted_launch(x.data_ptr(), out.data_ptr(),
                                               rounds, m, k, threads, ctas,
                                               stream):
                raise RuntimeError("design_sweep: launch failed")
            return out

        runs = {"two_operand": (run_two, "match_rounds_kernel")}
        for name, k in FOLDS:
            runs[f"{name} k={k}"] = (lambda name=name, k=k: run_fold(name, k),
                                     "match_rounds_shifted_kernel")
        row = {}
        for what, (fn, kname) in runs.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want[what]):
                raise AssertionError(f"design_sweep: t{two}f{fold}x"
                                     f"{threads} {what} != plain version")
            row[what] = device_ms(fn, kname)
        label = f"two_batch={two} fold_batch={fold} threads={threads}"
        res[label] = row
        print(label, json.dumps(row), flush=True)
    copy = torch.empty_like(va)
    res["va_copy_busy_ms"] = busy_ms(lambda: copy.copy_(va))
    res["va_round_sum_busy_ms"] = busy_ms(
        lambda: va.sum(0, dtype=torch.int32))
    return res


def step_probe_sweep(dev: torch.device) -> dict:
    tab, st = P.inputs(dev)
    lanes, width = tab.shape
    lib = D.LIB.get()
    stride = -(-4 * width // D.PROBE_ROW_ALIGN) * D.PROBE_ROW_ALIGN
    res = {}
    for reads in D.PROBE_READS:
        want = D.step_probe_ref(tab, st, P.STEPS, reads)
        row = {}
        for per in PROBE_LANES_PER_CTA:
            out = torch.empty_like(st)

            def fn(per=per, out=out):
                if lib.step_probe_launch(
                        tab.data_ptr(), st.data_ptr(), out.data_ptr(), lanes,
                        width, P.STEPS, reads, per, -(-lanes // per),
                        D.PROBE_ROW_ALIGN + per * stride,
                        torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("design_sweep: launch failed")
                return out

            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"design_sweep: step_probe reads="
                                     f"{reads}, {per} lanes a CTA")
            row[f"lanes_per_cta={per}"] = device_ms(fn, "step_probe_kernel")
        res[f"reads={reads}"] = row
        print(f"step_probe reads={reads}", json.dumps(row), flush=True)
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("design_sweep: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    print(json.dumps({"design_sweep": {
        "match_rounds": match_rounds_sweep(dev),
        "step_probe": step_probe_sweep(dev)}}), flush=True)


if __name__ == "__main__":
    main()
