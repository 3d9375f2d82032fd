"""Device time of this checkout's fold kernel against an older build's.

    python -m brotli_tpu_torch.research.fold_ab --old PATH

PATH is an older csrc/fold.cu with the first port's C interface (up to
commit 1ad7bee): fold_sorted_launch(key0, key1, pos, pays, n_pay,
out_packed, out_score, n, n_real, n_keys, fuse_short, k_fwd, k_back,
window, lbs, len_shift, min_pos, stream), which picks its own grid.
Unpack the older commit into a directory that .gitignore lists and
point PATH into it:

    git archive 1ad7bee | tar -x -C chip_proof/parent
    python -m brotli_tpu_torch.research.fold_ab \\
        --old chip_proof/parent/brotli_tpu_torch/csrc/fold.cu

The source is built with nvcc for sm_90a beside this checkout's.  On
chip_smoke.py's kernel-phase row (the first 4,718,592 bytes of the
seeded 32 MiB corpus, sorted as each configuration's wrapper sorts it),
every configuration of CONFIGS must give fold_sorted_ref's outputs bit
for bit in both builds.  Then each build takes its device_ms (devtime.py:
CUPTI duration, the L2 flushed before each call, median of 15 calls) in
the order old, new, new, old.  Prints the card's name and power limit,
then one JSON line: per configuration both readings of each build, old
/ new on their means, and this checkout's plan (fold_cuda.LAST_PLAN).
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
from ..ops import fold_cuda as F
from .corpus import SEED, make_corpus
from .devtime import device_ms

CORPUS_MIB = 32
ROW = 4_194_304 + 524_288   # halo + span of one lgwin-22 dispatch
WINDOW = (1 << 22) - 16
LBS, LEN_SHIFT = 135, 26

# (label, n_keys, n_pay, k_fwd, k_back, fuse_short, the path that
# launches it: "gpu" = compress_gpu, "max_device" = compress_gpu
# max_device, "mesh" = compress_mesh, None = no path of chip_smoke.py)
CONFIGS = [
    ("fold q2-6 exact", 1, 1, 32, 0, False, "gpu"),
    ("fold q7-8 exact8", 2, 0, 16, 8, False, "gpu"),
    ("fold q9 main", 2, 2, 16, 8, False, "gpu"),
    ("fold q9 short", 1, 1, 16, 0, False, "gpu"),
    ("fold exact9_fused", 2, 2, 16, 8, True, None),
    ("fold max_device q2-6", 1, 5, 32, 0, False, "max_device"),
    ("fold max_device q7-9", 1, 5, 16, 0, False, "max_device"),
    ("fold mesh q2-6", 1, 3, 32, 0, False, "mesh"),
]


def sorted_ops(row: torch.Tensor, n_keys: int, n_pay: int) -> list:
    """The sorted operands a configuration's wrapper folds: signed v0
    and n_pay payload words (one key), or unsigned (v0, v1) and n_pay
    more words (two keys)."""
    if n_keys == 1:
        return list(F._sort_v0(row, [F.u32_values_at(row, 4 * r)
                                     for r in range(1, n_pay + 1)]))
    return list(F._sort_v0v1(row, n_pay + 2))


def fold_args(n_keys, k_fwd, k_back, fuse, n_real, min_pos=0) -> dict:
    return dict(min_pos=min_pos, n_keys=n_keys, k_fwd=k_fwd,
                k_back=k_back, window=WINDOW, lbs=LBS,
                len_shift=LEN_SHIFT, n_real=n_real, fuse_short=fuse)


def _bind_old(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fold_sorted_launch.argtypes = ([vp] * 4 + [ci] + [vp] * 2
                                       + [ci] * 10 + [vp])
    lib.fold_sorted_launch.restype = ci


def old_fold(src: str):
    """The old build's fold as fn(ops, **fold_args) -> (packed, score)."""
    lib = CudaLibrary("fold_old", _bind_old, src=src).get()

    def run(ops, min_pos, n_keys, k_fwd, k_back, window, lbs, len_shift,
            n_real, fuse_short):
        n = ops[0].shape[0]
        n_pay = len(ops) - n_keys - 1
        packed = torch.empty(n, dtype=torch.int32, device=ops[0].device)
        score = torch.empty_like(packed)
        key1 = ops[1].data_ptr() if n_keys == 2 else None
        pays = (ctypes.c_void_p * F.MAX_PAY)(
            *[x.data_ptr() for x in ops[n_keys + 1:]])
        err = lib.fold_sorted_launch(
            ops[0].data_ptr(), key1, ops[n_keys].data_ptr(), pays, n_pay,
            packed.data_ptr(), score.data_ptr(), n, n_real, n_keys,
            int(fuse_short), k_fwd, k_back, window, lbs, len_shift, min_pos,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old fold: CUDA error {err}")
        return packed, score

    return run


def builds(old_src: str) -> dict:
    """name -> fold function; both sources built side by side."""
    old = CudaLibrary("fold_old", _bind_old, src=old_src)
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(x.build) for x in (old, F.LIB)]:
            f.result()
    return {"old": old_fold(old_src), "new": F.fold_sorted}


def run(old_src: str) -> dict:
    dev = torch.device("cuda", 0)
    fns = builds(old_src)
    row = torch.from_numpy(np.frombuffer(make_corpus(CORPUS_MIB, SEED)[:ROW],
                                         np.uint8).copy()).to(dev)
    res = {}
    for label, n_keys, n_pay, k_fwd, k_back, fuse, _ in CONFIGS:
        ops = sorted_ops(row, n_keys, n_pay)
        args = fold_args(n_keys, k_fwd, k_back, fuse, ROW)
        want = F.fold_sorted_ref(ops, **args)
        for name, fn in fns.items():
            got = fn(ops, **args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label}: {name} != fold_sorted_ref")
        plan = dict(F.LAST_PLAN)
        got = {k: [] for k in fns}
        for name in ("old", "new", "new", "old"):
            got[name].append(device_ms(lambda: fns[name](ops, **args),
                                       "fold_kernel"))
        mean = {k: sum(v) / len(v) for k, v in got.items()}
        res[label] = dict(device_ms=got, plan=plan,
                          old_over_new=mean["old"] / mean["new"])
        print(f"{label}: old {got['old']}, new {got['new']} ms; old / new "
              f"{mean['old'] / mean['new']:.3f}; plan {json.dumps(plan)}",
              flush=True)
        del ops, want
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="an older csrc/fold.cu (see the docstring)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fold_ab: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    print(json.dumps({"fold_ab": run(a.old)}), flush=True)


if __name__ == "__main__":
    main()
