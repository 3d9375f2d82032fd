"""Device time of this checkout's decode_step against an older build's.

    python -m brotli_tpu_torch.research.decode_ab --old PATH

PATH is an older csrc/decode_step.cu with the first port's C interface
(up to commit 9b1ccfd): decode_step_launch(ptrs, sizes, n_ptrs, stream) with 32
pointers (the rows, the lane vectors, the constant table in OLD_LAYOUT,
each tree's first / limit / offset / syms / single, the outputs) and 6
sizes, 32-lane CTAs.  Unpack the older commit into a directory that
.gitignore lists and point PATH into it:

    git archive 9b1ccfd | tar -x -C chip_proof/parent
    python -m brotli_tpu_torch.research.decode_ab \\
        --old chip_proof/parent/brotli_tpu_torch/csrc/decode_step.cu

The source is built with nvcc for sm_90a beside this checkout's.  On
chip_smoke.py's serving batch (1024 lanes) and on the multi-round
batch's first-round lanes (8 lanes of 4 MiB metablocks), the old build
must give the outputs and step counts of this checkout's kernel bit for
bit.  Then each takes its device_ms (devtime.py: CUPTI duration, the L2
flushed before each call; median of 15 calls on the serving lanes, of
3 on the multi-round lanes at a cap of MULTI_CAP steps) in the order
old, new, new, old.  Prints the card's name and power limit, then one
JSON line: per batch each build's readings, its microseconds a step of
the longest lane, this checkout's plan, and old / new.

With --once it launches the old build and this checkout's kernel once
each on the serving lanes and times nothing, for a profiler that
replays kernels (the stall reasons in PERF.md):

    ncu --section WarpStateStats --section SchedulerStats \
        -k regex:decode_step_kernel python -m \
        brotli_tpu_torch.research.decode_ab --old PATH --once
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
from ..decode import batch_gpu as B
from ..ops import decode_gpu as D
from .corpus import SEED, make_corpus
from .decode_batches import (lanes_of, multi_round_batch, native_encoder,
                             serving_batch)
from .devtime import device_ms

CORPUS_MIB = 32
MULTI_CAP = 200_000   # about 0.5 s a launch of the first port's kernel
REPS = {"serving": 15, "multi-round": 3}
#: the first port's constant table, in its T_* order
OLD_LAYOUT = ("ins_base", "ins_extra", "cpy_base", "cpy_extra", "cmd2ins",
              "cmd2cpy", "implicit0", "sc_idx", "sc_delta", "dict_sbits",
              "dict_outlen")


def _bind_old(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.decode_step_launch.argtypes = [vp, vp, ci, vp]
    lib.decode_step_launch.restype = ci


def old_decoder(src: str):
    """The old build's decode as fn(args, max_steps, s_lit, s_cmd,
    steps) -> the seven outputs, args as batch_gpu.lane_arrays gives
    them (the first port's wrapper)."""
    lib = CudaLibrary("decode_step_old", _bind_old, src=src).get()

    def run(args, max_steps, s_lit, s_cmd, steps):
        (data, bit0, mlen, window, npostfix, ndirect, cache0, lit_len,
         cmd_len, dist_len, out_prefix) = args
        n, L = data.shape
        dev = data.device
        i32 = torch.int32
        t = D._tables_np()
        table = torch.from_numpy(np.concatenate(
            [np.asarray(t[k], np.int32) for k in OLD_LAYOUT])).to(dev)
        trees = [D.build_tree_device(x) for x in (lit_len, cmd_len, dist_len)]
        ins = [x.to(i32).contiguous() for x in
               (bit0, mlen, window, npostfix, ndirect, out_prefix, cache0)]
        lits = torch.zeros((n, s_lit), dtype=torch.uint8, device=dev)
        cmds = torch.zeros((n, s_cmd, 3), dtype=i32, device=dev)
        outs = [torch.empty(n, dtype=i32, device=dev) for _ in range(4)]
        cache = torch.empty((n, 4), dtype=i32, device=dev)
        ptrs = [data.contiguous()] + ins + [table]
        for tr in trees:
            ptrs += [tr[k] for k in ("first", "limit", "offset", "syms",
                                     "single")]
        ptrs += [lits, cmds, *outs, cache, steps]
        sizes = [n, L, trees[2]["syms"].shape[1], max_steps, s_lit, s_cmd]
        p_arr = (ctypes.c_int64 * len(ptrs))(*[x.data_ptr() for x in ptrs])
        s_arr = (ctypes.c_int64 * len(sizes))(*sizes)
        err = lib.decode_step_launch(p_arr, s_arr, len(ptrs),
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old decode_step: CUDA error {err}")
        nlit, ncmd, end_bit, status = outs
        return lits, nlit, cmds, ncmd, end_bit, status, cache

    return run


def new_decoder(args, max_steps, s_lit, s_cmd, steps):
    """This checkout's launch, with old_decoder's arguments."""
    return D._decode_step_cuda(*args, max_steps, s_lit, s_cmd, steps)


def builds(old_src: str) -> dict:
    """name -> decode function; both sources built side by side."""
    old = CudaLibrary("decode_step_old", _bind_old, src=old_src)
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(x.build) for x in (old, D.LIB)]:
            f.result()
    return {"old": old_decoder(old_src), "new": new_decoder}


def _decode(fn, args, cap, s_lit, s_cmd):
    steps = torch.zeros(args[0].shape[0], dtype=torch.int32,
                        device=args[0].device)
    out = fn(args, cap, s_lit, s_cmd, steps)
    torch.cuda.synchronize()
    return list(out) + [steps]


def once(old_src: str) -> None:
    """The old build and this checkout's kernel, one launch each on the
    serving lanes."""
    dev = torch.device("cuda", 0)
    fns = builds(old_src)
    streams = serving_batch(make_corpus(CORPUS_MIB, SEED), native_encoder(),
                            dev)[0]
    args, full, s_lit, s_cmd = B.lane_arrays(lanes_of(streams), dev)
    for name in ("old", "new"):
        _decode(fns[name], args, full, s_lit, s_cmd)
        print(f"serving: {name} launched once", flush=True)


def run(old_src: str) -> dict:
    dev = torch.device("cuda", 0)
    fns = builds(old_src)
    corpus = make_corpus(CORPUS_MIB, SEED)
    enc = native_encoder()
    batches = {"serving": serving_batch(corpus, enc, dev)[0],
               "multi-round": multi_round_batch(corpus, dev)[0]}
    res = {}
    for batch, streams in batches.items():
        lanes = lanes_of(streams)
        args, full, s_lit, s_cmd = B.lane_arrays(lanes, dev)
        n = len(lanes)
        want = _decode(fns["new"], args, full, s_lit, s_cmd)
        for name, fn in fns.items():
            got = _decode(fn, args, full, s_lit, s_cmd)
            for k, (g, w) in enumerate(zip(got, want)):
                if not torch.equal(g, w):
                    raise AssertionError(f"{batch}: {name} differs from new "
                                         f"in output {k}")
        if not bool((want[5] == D.PH_DONE).all()):
            raise AssertionError(f"{batch}: a lane did not finish")
        cap = MULTI_CAP if batch == "multi-round" else full
        longest = min(int(want[7].max()), cap)
        plan = dict(D.LAST_PLAN)
        got = {k: [] for k in fns}
        for name in ("old", "new", "new", "old"):
            got[name].append(device_ms(
                lambda: fns[name](args, cap, s_lit, s_cmd,
                                  torch.empty(n, dtype=torch.int32,
                                              device=dev)),
                "decode_step_kernel", reps=REPS[batch]))
            print(f"{batch}: {name} device ms {got[name][-1]:.3f}",
                  flush=True)
        mean = {k: sum(v) / len(v) for k, v in got.items()}
        res[batch] = dict(
            lanes=n, cap=cap, longest_lane_steps=longest,
            steps=int(want[7].clamp(max=cap).sum()),
            plan=plan,
            device_ms=got,
            us_per_step={k: v * 1e3 / longest for k, v in mean.items()},
            old_over_new=mean["old"] / mean["new"])
        print(f"{batch}: {n} lanes, longest lane {longest} steps; old / new "
              f"{mean['old'] / mean['new']:.3f}", flush=True)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="an older csrc/decode_step.cu (see the docstring)")
    ap.add_argument("--once", action="store_true",
                    help="one launch of each kernel, no timing")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_ab: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(card.strip().splitlines()[0], flush=True)
    if a.once:
        once(a.old)
        return
    print(json.dumps({"decode_ab": run(a.old)}), flush=True)


if __name__ == "__main__":
    main()
