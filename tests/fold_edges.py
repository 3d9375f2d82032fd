"""Fold inputs that reach the edges of csrc/fold.cu's design, made from
a numpy seed: a v0 run longer than a tile, runs across tile edges, fewer
rows than a tile, a window shorter than most distances, and an n_real
so close to the last rows that limit caps their lengths.  Shared by the
CPU test of the fold's exits and the card tests."""

import numpy as np

from brotli_tpu_torch.ops.fold_cuda import TILE_ROWS
from brotli_tpu_torch.research import fold_ab

# (n_keys, n_pay, k_fwd, k_back, fuse_short) of chip_smoke.py's seven
# folds (q2-6, q7-8, q9 main, q9 short, exact9_fused, max_device q2-6 /
# q7-9)
CONFIGS = [c[1:6] for c in fold_ab.CONFIGS]
CASES = ["long run", "tile edges", "below a tile", "small window",
         "limit"]


def phrases(n: int, seed: int, kinds: int = 64) -> np.ndarray:
    """Repeats of `kinds` phrases (matches at many distances), near
    repeats and random bytes, so key words with the top bit set are
    common."""
    rng = np.random.default_rng(seed)
    table = [rng.integers(0, 256, size=int(rng.integers(3, 48)),
                          dtype=np.uint8) for _ in range(kinds)]
    out, total = [], 0
    while total < n:
        if rng.random() < 0.2:
            piece = rng.integers(0, 256, size=int(rng.integers(1, 24)),
                                 dtype=np.uint8)
        else:
            piece = table[int(rng.integers(0, len(table)))].copy()
            if rng.random() < 0.3:
                piece[int(rng.integers(0, len(piece)))] ^= 0x80
        out.append(piece)
        total += len(piece)
    return np.concatenate(out)[:n]


def edge_case(case: str, seed: int = 0):
    """(data uint8, window, n_real) of one of CASES."""
    t = TILE_ROWS
    if case == "long run":
        data = np.concatenate([phrases(700, seed),
                               np.full(3 * t + 77, 0x61, np.uint8),
                               phrases(900, seed + 1)])
        return data, 1 << 16, len(data)
    if case == "tile edges":
        data = phrases(5 * t + 37, seed)
        return data, 1 << 16, len(data)
    if case == "below a tile":
        data = phrases(t // 2 + 3, seed, kinds=4)
        return data, 1 << 16, len(data)
    if case == "small window":
        data = phrases(4 * t + 11, seed, kinds=4)
        return data, 48, len(data)
    if case == "limit":
        data = np.concatenate([phrases(2 * t, seed),
                               np.zeros(300, np.uint8)])
        return data, 1 << 16, len(data) - 40
    raise ValueError(case)
