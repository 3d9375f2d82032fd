"""Per-context prior evaluation, adaptive-speed search and 2-model mixing.

A copy of brotli_tpu/utils/prior.py, the same numpy operations in the
same order (Weights' Q16 truncation and the tie order of PRIOR_NAMES
included), so every field comes out equal:

- prior_eval.rs (WhichPrior {CM, SLOW_CM, FAST_CM, STRIDE1-4, ADV},
  16-nibble adaptive CDFs scored per literal context, picking a
  per-context mixing-strategy bitmask for prior_bitmask_detection);
- context_map_entropy.rs (candidate CDF adaptation speeds evaluated
  against the literal stream, best written into the PredictionMode
  speed fields);
- weights.rs (fixed-point 2-model probability blend whose weight adapts
  toward the better-predicting model: the ADV prior's mixing cost).

Everything here measures the encoder's own literal stream; results
ride in the IR PredictionMode record, not the wire format.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# candidate adaptation speeds (inc, max) — reference
# context_map_entropy.rs NUM_SPEEDS_TO_TRY table
CANDIDATE_SPEEDS = [(0, 1024), (1, 1024), (1, 4096), (2, 1024),
                    (4, 1024), (8, 8192), (16, 48), (16, 8192),
                    (32, 4096), (64, 16384), (128, 16384), (512, 16384)]

PRIOR_NAMES = ["CM", "SLOW_CM", "FAST_CM", "STRIDE1", "STRIDE2",
               "STRIDE3", "STRIDE4", "ADV"]


class Weights:
    """Fixed-point 2-model probability mixer (reference weights.rs:1-147).

    Maintains a weight w in [0, 1] (Q16 fixed point) blending two
    per-symbol probabilities; after each symbol the weight moves toward
    the model that assigned the higher probability to what actually
    occurred (normalized gradient step, like the reference's
    floating_point_context_mixing-gated update).
    """

    __slots__ = ("w", "lr")

    def __init__(self, w0: float = 0.5, lr: float = 0.02):
        self.w = int(w0 * 65536)
        self.lr = int(lr * 65536)

    def mix(self, p0: float, p1: float) -> float:
        w = self.w / 65536.0
        return w * p0 + (1.0 - w) * p1

    def update(self, p0: float, p1: float):
        mixed = self.mix(p0, p1)
        if mixed <= 0:
            return
        grad = (p0 - p1) / mixed
        step = int(self.lr * max(-4.0, min(4.0, grad)))
        self.w = max(0, min(65536, self.w + step))


def _nibble_stream(literals: np.ndarray) -> np.ndarray:
    """High then low nibble per literal (the reference codes literals
    as two 16-ary CDF draws)."""
    out = np.empty(2 * len(literals), np.int64)
    out[0::2] = literals >> 4
    out[1::2] = literals & 15
    return out


def _ctx_adaptive_cost(ctx: np.ndarray, sym: np.ndarray, nctx: int,
                       inc: int, cap: int, chunk: int = 4096):
    """Total bits to code sym[i] with a per-context adaptive 16-ary
    frequency model (increment inc, renormalize at cap), evaluated
    chunk-wise — vectorized form of prior_eval's CDF scoring."""
    freq = np.ones((nctx, 16), np.float64)
    total = 0.0
    for c0 in range(0, len(sym), chunk):
        cc = ctx[c0:c0 + chunk]
        ss = sym[c0:c0 + chunk]
        tot = freq.sum(axis=1)
        p = freq[cc, ss] / tot[cc]
        total += float(-np.log2(np.maximum(p, 1e-12)).sum())
        np.add.at(freq, (cc, ss), float(max(inc, 1)))
        over = freq.sum(axis=1) > cap
        if over.any():
            freq[over] = np.maximum(freq[over] * 0.5, 1.0)
    return total


@dataclass
class PriorReport:
    per_context: list            # WhichPrior name per coarse context
    bitmask: int                 # bit c set -> context c prefers CM-family
    costs: dict                  # prior family -> total bits
    cm_speed: tuple              # best (inc, max) for the CM model
    stride_speed: tuple          # best (inc, max) for the stride model
    mix_weight: float            # final ADV mixing weight (weights.rs)
    stride: int = 1


def find_speed(literals: np.ndarray, nctx_arr: np.ndarray, nctx: int):
    """Best (inc, max) adaptation speed for a context model over the
    literal nibbles (reference context_map_entropy.rs search)."""
    sym = _nibble_stream(literals)
    ctx = np.repeat(nctx_arr, 2)
    best, best_cost = CANDIDATE_SPEEDS[0], float("inf")
    for inc, cap in CANDIDATE_SPEEDS:
        cost = _ctx_adaptive_cost(ctx, sym, nctx, inc, cap)
        if cost < best_cost:
            best_cost, best = cost, (inc, cap)
    return best, best_cost


def prior_eval(data: bytes, sample_limit: int = 1 << 20) -> PriorReport:
    """Per-context prior family selection (reference prior_eval.rs).

    Contexts are the 16 high-nibble-of-previous-byte classes (a coarse
    view of the 64-context UTF8 map: cheap and stable on samples).  For
    each context the CM family (3 adaptation speeds), stride-s
    predictors (s in 1..4), and the 2-model ADV mix are scored; the
    per-context argmin forms the WhichPrior assignment and the CM
    bitmask.
    """
    arr = np.frombuffer(bytes(data), np.uint8)[:sample_limit]
    if len(arr) < 16:
        return PriorReport(["CM"] * 16, 0xFFFF, {}, (16, 8192),
                           (16, 8192), 0.5)
    lits = arr[8:].astype(np.int64)
    base = 8
    nctx = 16
    cm_ctx = (arr[base - 1:-1] >> 4).astype(np.int64)

    sym = _nibble_stream(lits)
    cm_ctx2 = np.repeat(cm_ctx, 2)

    costs = {}
    per_ctx_cost = {}

    def score(name, ctx2, inc, cap):
        # per-context total bits under this prior
        freq = np.ones((nctx, 16), np.float64)
        tot_bits = np.zeros(nctx, np.float64)
        chunk = 4096
        for c0 in range(0, len(sym), chunk):
            cc = ctx2[c0:c0 + chunk]
            ss = sym[c0:c0 + chunk]
            tot = freq.sum(axis=1)
            bits = -np.log2(np.maximum(freq[cc, ss] / tot[cc], 1e-12))
            np.add.at(tot_bits, cc, bits)
            np.add.at(freq, (cc, ss), float(max(inc, 1)))
            over = freq.sum(axis=1) > cap
            if over.any():
                freq[over] = np.maximum(freq[over] * 0.5, 1.0)
        costs[name] = float(tot_bits.sum())
        per_ctx_cost[name] = tot_bits

    score("CM", cm_ctx2, 16, 8192)
    score("SLOW_CM", cm_ctx2, 4, 16384)
    score("FAST_CM", cm_ctx2, 64, 1024)
    for s in (1, 2, 3, 4):
        sctx = (arr[base - s:len(arr) - s] >> 4).astype(np.int64)
        score(f"STRIDE{s}", np.repeat(sctx, 2), 16, 8192)

    # ADV: 2-model blend of CM and the best stride prior via Weights
    best_stride = min(range(1, 5),
                      key=lambda s: costs[f"STRIDE{s}"])
    sctx = (arr[base - best_stride:len(arr) - best_stride] >> 4) \
        .astype(np.int64)
    sctx2 = np.repeat(sctx, 2)
    mixer = Weights()
    freq_cm = np.ones((nctx, 16), np.float64)
    freq_st = np.ones((nctx, 16), np.float64)
    adv_bits = np.zeros(nctx, np.float64)
    chunk = 4096
    for c0 in range(0, len(sym), chunk):
        cc, sc = cm_ctx2[c0:c0 + chunk], sctx2[c0:c0 + chunk]
        ss = sym[c0:c0 + chunk]
        p_cm = freq_cm[cc, ss] / freq_cm.sum(axis=1)[cc]
        p_st = freq_st[sc, ss] / freq_st.sum(axis=1)[sc]
        w = mixer.w / 65536.0
        p = w * p_cm + (1 - w) * p_st
        bits = -np.log2(np.maximum(p, 1e-12))
        np.add.at(adv_bits, cc, bits)
        mixer.update(float(p_cm.mean()), float(p_st.mean()))
        np.add.at(freq_cm, (cc, ss), 16.0)
        np.add.at(freq_st, (sc, ss), 16.0)
        for fr in (freq_cm, freq_st):
            over = fr.sum(axis=1) > 8192
            if over.any():
                fr[over] = np.maximum(fr[over] * 0.5, 1.0)
    costs["ADV"] = float(adv_bits.sum())
    per_ctx_cost["ADV"] = adv_bits

    per_context = []
    bitmask = 0
    for c in range(nctx):
        best = min(PRIOR_NAMES,
                   key=lambda nm: float(per_ctx_cost[nm][c]))
        per_context.append(best)
        if best in ("CM", "SLOW_CM", "FAST_CM", "ADV"):
            bitmask |= 1 << c
    cm_speed, _ = find_speed(lits, cm_ctx, nctx)
    st_speed, _ = find_speed(lits, sctx, nctx)
    return PriorReport(per_context=per_context, bitmask=bitmask,
                       costs={k: round(v, 1) for k, v in costs.items()},
                       cm_speed=cm_speed, stride_speed=st_speed,
                       mix_weight=round(mixer.w / 65536.0, 4),
                       stride=best_stride)
