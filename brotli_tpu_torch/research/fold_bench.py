"""The fold mirrors against the CUDA tier wrappers on one card.

    python -m brotli_tpu_torch.research.fold_bench

Counterpart of research/fold_pallas_bench.py, which times the JAX
package's XLA fold mirrors ("old") against its Pallas tier wrappers
("new").  Here "old" is a mirror of ops/matching.py (plain torch ops:
sorts, slices, elementwise ops, one scatter a fold) and "new" the tier
wrapper of ops/fold_cuda.py that computes the same function (sorts,
the CUDA fold, the inversion on the device).

The input is the row compress_gpu dispatches for the 512 KiB span at
4 MiB of the seeded 32 MiB corpus at lgwin 22: its 4 MiB halo full
(min_pos 0), 4,718,592 rows.  At the q5, q7 and q9 settings of
encode/gpu_path._device_knobs each of the five public mirrors runs on
the card, and at max_device's q5 and q9 settings the exact mirror with
6 attested rounds.  best_matches_exact, _exact8 and _exact9 must equal
best_matches_exact_p, _exact8_p and _exact9_p bit for bit, and every
mirror's card result must equal its result on the CPU (the same
function on CPU tensors).  Times: CUDA events around one call, median
of REPS.  Prints the card's name and power limit, a line a case, then
one JSON line.  `run(device="cpu", row=...)` rehearses the control flow
on the host and measures nothing (times None).
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from ..device import resolve_device
from ..encode.gpu_path import LEN_SHIFT, _device_knobs
from ..ops import fold_cuda as F
from ..ops import matching as M
from .corpus import SEED, make_corpus
from .devtime import median_ms
from .fold_ab import CORPUS_MIB, ROW, WINDOW

REPS = 5


def cases() -> list:
    """(setting, mirror, its keyword arguments, the tier wrapper that
    computes the same function or None, its keyword arguments)."""
    out = []
    for q in (5, 7, 9):
        kn = _device_knobs(q)
        k, k8, rounds = kn["k"], kn["k8"], kn["rounds"]
        short = dict(k=k, k_short=max(k8, 8), rounds=rounds)
        out += [
            (f"q{q}", "packed", dict(k=k, k8=k8, rounds=rounds), None, None),
            (f"q{q}", "fused", dict(k=k, k8=k8, rounds=rounds), None, None),
            (f"q{q}", "exact", dict(k=k, k8=0, rounds=rounds),
             "exact", dict(k=k, rounds=rounds)),
            (f"q{q}", "exact8", dict(k=k, rounds=rounds),
             "exact8", dict(k=k, rounds=rounds)),
            (f"q{q}", "exact9", short, "exact9", short)]
    for q in (5, 9):   # gpu_path._match_parse_dense's fold
        k = _device_knobs(q)["k"]
        out.append((f"max_device q{q}", "exact", dict(k=k, k8=0, rounds=6),
                    "exact", dict(k=k, rounds=6)))
    return out


def _mirror(name: str):
    fn = getattr(M, "best_matches_" + name)
    if name == "packed":   # (score << 6 | len, dist); no len_shift
        return lambda d, **kw: fn(d, WINDOW, **kw)
    return lambda d, **kw: (fn(d, WINDOW, len_shift=LEN_SHIFT, **kw),)


def _wrapper(name: str):
    fn = getattr(F, f"best_matches_{name}_p")
    return lambda d, **kw: (fn(d, WINDOW, len_shift=LEN_SHIFT, **kw),)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def span_row(device) -> torch.Tensor:
    """compress_gpu's row for the span at 4 MiB of the seeded corpus."""
    data = np.frombuffer(make_corpus(CORPUS_MIB, SEED)[:ROW], np.uint8)
    return torch.from_numpy(data.copy()).to(device)


def run(device=None, row: torch.Tensor | None = None, log=print) -> list:
    """Every case of cases() on `row` (default span_row) on the device
    (None: the current CUDA card); raises where a mirror differs from
    its tier wrapper or from its CPU result.  Returns a dict a case."""
    dev = resolve_device(device)
    row = span_row(dev) if row is None else row.to(dev)
    row_cpu = row.cpu()
    on_card = dev.type == "cuda"
    res = []
    for setting, name, kw, wname, wkw in cases():
        mirror = _mirror(name)
        got = mirror(row, **kw)
        if any(g.device.type != dev.type for g in got):
            raise AssertionError(f"{setting} {name}: output not on {dev}")
        entry = dict(setting=setting, mirror=f"best_matches_{name}",
                     args=kw, rows=int(row.shape[0]),
                     matches=int((got[0] != 0).sum()), wrapper=None,
                     mirror_ms=None, wrapper_ms=None)
        if entry["matches"] == 0:
            raise AssertionError(f"{setting} {name}: no matches found")
        if wname is not None:
            wrapper = _wrapper(wname)
            if not _same(got, wrapper(row, **wkw)):
                raise AssertionError(f"{setting}: best_matches_{name} != "
                                     f"best_matches_{wname}_p")
            entry["wrapper"] = f"best_matches_{wname}_p"
        if on_card:
            want = mirror(row_cpu, **kw)
            if not _same([g.cpu() for g in got], want):
                raise AssertionError(f"{setting} best_matches_{name}: card "
                                     "!= CPU")
            entry["mirror_ms"] = median_ms(lambda: mirror(row, **kw), REPS)
            if wname is not None:
                entry["wrapper_ms"] = median_ms(lambda: wrapper(row, **wkw),
                                                REPS)
        log(f"mirror {setting} best_matches_{name} {json.dumps(kw)}: "
            f"{entry['matches']} matches"
            + (f", equal to {entry['wrapper']}" if wname else "")
            + (f", card == CPU; mirror {entry['mirror_ms']:.3f} ms"
               if on_card else "")
            + (f", wrapper {entry['wrapper_ms']:.3f} ms"
               if on_card and wname else ""))
        res.append(entry)
        del got
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fold_bench: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    card = card.strip().splitlines()[0]
    print(card, flush=True)
    res = run(log=lambda *x: print(*x, flush=True))
    print(json.dumps({"fold_bench": res, "card": card}), flush=True)


if __name__ == "__main__":
    main()
