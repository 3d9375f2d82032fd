"""What the request kinds share to plant a fault under the program (the
control of `correct` and the tests): a byte changed, and the seeded
stream the faults draw from.  The benchmark's own runs plant none."""

from __future__ import annotations

import numpy as np

from corpus import seed_seq

FAULTS = ("control", "alter", "unchanged", "half")


def flip(b: bytes, at: int) -> bytes:
    """`b` with the byte at `at` (modulo its length) changed."""
    if not b:
        return b"\x00"
    at %= len(b)
    return b[:at] + bytes([b[at] ^ 0x5A]) + b[at + 1:]


def rng(seed: int):
    return np.random.default_rng(seed_seq(seed, 9))
