"""Request kind "compress": one file in, one stream out.

The pool is a mix of kind "files" (traffic.Files).  The check decodes
every stream the window produced with libbrotlidec (reference.py) and
compares it with its file byte for byte.
"""

from __future__ import annotations

import numpy as np

import faults
import reference
from traffic import Files


class Requests:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.pool = Files(traffic, seed)
        self.kept = []

    def describe(self) -> str:
        return (f"inputs sha256 {self.pool.sha256()} ({len(self.pool.pool)} "
                f"files, {sum(self.pool.sizes)} bytes, numpy "
                f"{np.__version__})")

    def warm(self) -> list:
        return self.pool.warm()

    def order(self):
        return self.pool.order()

    def payload(self, x):
        return self.pool.pool[x]

    def size_in(self, payload) -> int:
        return len(payload)

    def answered(self, r: int, x, payload, answer) -> int:
        self.kept.append((answer, payload))
        return len(answer)

    def check(self, n_requests: int, failed: int):
        checks = {"bad_streams": (reference.bad_streams(self.kept),
                                  "at_most", 0),
                  "failed_requests": (failed, "at_most", 0)}
        return checks, (f"checked {len(self.kept)} streams of {n_requests} "
                        "requests through libbrotlidec")

    def broken(self, call, fault: str, seed: int):
        """`call` with a fault planted (faults.FAULTS):
          control    the file with one seeded byte changed is compressed
                     (a lossy near miss)
          alter      a byte of each stream altered where it is produced
          unchanged  the file handed back as the stream
          half       only the first half of the file compressed"""
        rng = faults.rng(seed)
        if fault == "control":
            return lambda f: call(faults.flip(f, int(rng.integers(1 << 30))))
        if fault == "alter":
            return lambda f: faults.flip(call(f), len(f) // 2 + 7)
        if fault == "unchanged":
            return lambda f: bytes(f)
        if fault == "half":
            return lambda f: call(f[:len(f) // 2])
        raise ValueError(f"unknown fault {fault!r}")
