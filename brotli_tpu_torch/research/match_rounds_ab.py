"""Device time of this checkout's match_rounds kernel against an older
build's.

    python -m brotli_tpu_torch.research.match_rounds_ab --old PATH

PATH is an older csrc/match_rounds.cu with the first port's C
interface (up to commit 67d0b26): match_rounds_launch(va, vb, out,
rounds, m, stream), the two-operand chain only, which picks its own
grid.  Unpack it into a directory that .gitignore lists:

    git archive 67d0b26 brotli_tpu_torch/csrc/match_rounds.cu \\
        | tar -x -C chip_proof/parent
    python -m brotli_tpu_torch.research.match_rounds_ab \\
        --old chip_proof/parent/brotli_tpu_torch/csrc/match_rounds.cu

Both sources are built with nvcc for sm_90a side by side.  The inputs
are the first 4 MiB shard of the seeded 32 MiB corpus, as compress_fast
matches it: its R = 8 chunk values in the h4 table's hash order and in
the h8 table's (sorted_rounds).  Each build must equal the plain
versions bit for bit there: the old two-operand kernel on every shifted
operand, this checkout's two-operand kernel on the shift by 1 and its
fold form at k = 2 (h4) and k = 1 (h8).  Then, in the order old, new,
new, old:

  kernel  the two-operand kernel on the h4 order against its shift by
          1: the kernel's device ms (devtime.device_ms)
  chains  one shard's three match-length chains as ops/matching.py
          _fold_sorted runs them: old = for (h4, 1), (h4, 2), (h8, 1) a
          zero fill, the shifted copy and a two-operand launch; new =
          the fold form on h4 at k = 2 and on h8 at k = 1; the device
          busy ms of the whole (devtime.busy_ms: every kernel, fill and
          copy)

Prints the card's name and power limit, then one JSON line: both
readings of each build for each measure, old / new on their means, and
the plans this checkout launched (match_rounds_cuda.LAST_PLAN).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..buildcache import CudaLibrary
from ..ops import match_rounds_cuda as MR
from ..ops import matching as M
from .corpus import SEED, make_corpus
from .devtime import busy_ms, device_ms

CORPUS_MIB = 32
SHARD = 1 << 22             # compress_fast's shard
ROUNDS = M.LEN_CAP // 4
# (table, offsets) of compress_fast's two folds (encode/fast.py: k = 2,
# k8 = 1)
FOLDS = (("h4", 2), ("h8", 1))


def sorted_rounds(data: torch.Tensor) -> dict:
    """The fold operands of best_matches_block on a uint8 shard: its
    R chunk values (int32 [R, n]) in each table's stable hash order,
    under "h4" (17 bucket bits) and "h8" (18)."""
    vs = [M.u32_values_at(data, 4 * r) for r in range(ROUNDS)]
    h4 = M.mul32(vs[0], M.HASH_MUL32) >> (32 - 17)
    h8 = (M.mul32(vs[0], M.HASH_MUL32) ^ M.mul32(vs[1], M.HASH_MUL32B)) \
        >> (32 - 18)
    w = torch.stack([M.as_i32(v) for v in vs])
    return {name: w[:, torch.argsort(h, stable=True)]
            for name, h in (("h4", h4), ("h8", h8))}


def rounds_needed(va: torch.Tensor, k: int):
    """For the fold of va at offsets 1..k: the rounds each chain needs
    (int64 [k, M], up to and with its first unequal round) and the va
    words some chain needs, as either side, counted once."""
    rounds, m = va.shape
    need = []
    words = torch.zeros(m, dtype=torch.int64, device=va.device)
    for j in range(1, k + 1):
        nz = (va ^ MR.shift_rounds(va, j)) != 0
        first = torch.where(nz.any(0), nz.int().argmax(0) + 1, rounds)
        need.append(first)
        words = torch.maximum(words, first)
        words[:m - j] = torch.maximum(words[:m - j], first[j:])
    return torch.stack(need), int(words.sum())


def _bind_old(lib) -> None:
    vp = ctypes.c_void_p
    lib.match_rounds_launch.argtypes = [vp, vp, vp, ctypes.c_int,
                                        ctypes.c_int64, vp]
    lib.match_rounds_launch.restype = ctypes.c_int


def old_rounds(src: str):
    """The old build's two-operand chain as fn(va, vb) -> int32 [M]."""
    lib = CudaLibrary("match_rounds_old", _bind_old, src=src).get()

    def run(va, vb):
        out = torch.empty(va.shape[1], dtype=torch.int32, device=va.device)
        err = lib.match_rounds_launch(
            va.data_ptr(), vb.data_ptr(), out.data_ptr(), va.shape[0],
            va.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old match_rounds: CUDA error {err}")
        return out

    return run


def run(old_src: str) -> dict:
    dev = torch.device("cuda", 0)
    old = CudaLibrary("match_rounds_old", _bind_old, src=old_src)
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(x.build) for x in (old, MR.LIB)]:
            f.result()
    old_fn = old_rounds(old_src)
    shard = torch.from_numpy(np.frombuffer(
        make_corpus(CORPUS_MIB, SEED)[:SHARD], np.uint8).copy()).to(dev)
    ops = sorted_rounds(shard)
    del shard
    va = ops["h4"]
    vb1 = MR.shift_rounds(va, 1)
    plans = {}

    def check(what, got, want):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel != plain version "
                                 f"({int((got != want).sum())} differ)")

    want1 = MR.match_rounds_ref(va, vb1)
    check("old two-operand j=1", old_fn(va, vb1), want1)
    check("new two-operand j=1", MR.match_rounds(va, vb1), want1)
    plans["two_operand"] = dict(MR.LAST_PLAN)
    for name, k in FOLDS:
        want = MR.match_rounds_shifted_ref(ops[name], k)
        check(f"new fold form {name} k={k}",
              MR.match_rounds_shifted(ops[name], k), want)
        plans[f"{name} k={k}"] = dict(MR.LAST_PLAN)
        for j in range(1, k + 1):
            check(f"old {name} j={j}",
                  old_fn(ops[name], MR.shift_rounds(ops[name], j)),
                  want[j - 1])
        del want

    def old_chains():
        for name, k in FOLDS:
            for j in range(1, k + 1):
                x = ops[name]
                vb = torch.zeros_like(x)
                vb[:, j:] = x[:, :x.shape[1] - j]
                old_fn(x, vb)

    def new_chains():
        for name, k in FOLDS:
            MR.match_rounds_shifted(ops[name], k)

    measures = {
        "kernel": ({"old": lambda: old_fn(va, vb1),
                    "new": lambda: MR.match_rounds(va, vb1)},
                   lambda fn: device_ms(fn, "match_rounds_kernel")),
        "chains": ({"old": old_chains, "new": new_chains}, busy_ms),
    }
    res = {}
    for what, (fns, timer) in measures.items():
        got = {"old": [], "new": []}
        for name in ("old", "new", "new", "old"):
            got[name].append(timer(fns[name]))
        mean = {k: sum(v) / len(v) for k, v in got.items()}
        res[what] = dict(device_ms=got, old_over_new=mean["old"] / mean["new"])
        print(f"{what}: old {got['old']}, new {got['new']} ms; old / new "
              f"{mean['old'] / mean['new']:.3f}", flush=True)
    res["plans"] = plans
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="an older csrc/match_rounds.cu (see the docstring)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("match_rounds_ab: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(json.dumps({"match_rounds_ab": run(a.old)}), flush=True)


if __name__ == "__main__":
    main()
