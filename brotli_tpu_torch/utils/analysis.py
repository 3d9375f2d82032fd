"""IR analysis extensions: stride / prior / adaptation-speed detection.

A copy of brotli_tpu/utils/analysis.py, the same numpy operations in
the same order, so every float comes out equal.  The reference's
research side channel (stride_detection_quality,
prior_bitmask_detection, the CLI's -findprior / -findspeed / -stride
flags): multi-resolution entropy buckets score candidate STRIDE
predictors (find_stride.rs EntropyPyramid, stride_eval.rs StrideEval),
the stride costs pick a prior family (prior_eval.rs WhichPrior), and
candidate CDF adaptation speeds are scored against the literal stream
(context_map_entropy.rs).  Results ride in the IR PredictionMode
record, not in the wire format.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# candidate adaptation speeds (inc, max), reference interface.rs speed
# metadata / context_map_entropy.rs NUM_SPEEDS_TO_TRY
CANDIDATE_SPEEDS = [(0, 1024), (1, 1024), (1, 4096), (2, 1024),
                    (4, 1024), (8, 8192), (16, 48), (16, 8192),
                    (32, 4096), (64, 16384), (128, 16384), (512, 16384)]

MAX_STRIDE = 8


@dataclass
class AnalysisResult:
    best_stride: int
    stride_costs: list          # bits/byte per stride 1..8
    cm_speed: tuple             # (inc, max) for the context-map model
    stride_speed: tuple         # (inc, max) for the stride model
    prior: str                  # chosen prior family (CM / STRIDE / ADV)
    region_len: int = 0         # pyramid region size (advanced mode)
    region_strides: list = None  # per-region best stride (advanced)


def stride_entropy_costs(data: np.ndarray, max_stride: int = MAX_STRIDE):
    """Bits/byte of coding each byte conditioned on the byte `stride`
    back, using the top nibble as context (the vector analog of
    StrideEval's per-stride CDF cost, reference stride_eval.rs:93-210)."""
    n = len(data)
    costs = []
    for stride in range(1, max_stride + 1):
        if n <= stride:
            costs.append(8.0)
            continue
        ctx = (data[:-stride] >> 4).astype(np.int64)
        sym = data[stride:].astype(np.int64)
        hist = np.zeros((16, 256), np.float64)
        np.add.at(hist, (ctx, sym), 1)
        tot = hist.sum(axis=1, keepdims=True)
        p = (hist + 0.25) / (tot + 64.0)
        bits = -(hist * np.log2(p)).sum()
        costs.append(float(bits / max(1, n - stride)))
    return costs


def adaptive_cost(symbols: np.ndarray, inc: int, cap: int,
                  nibble: bool = True, chunk: int = 512) -> float:
    """Total bits to code `symbols` with an adaptive frequency model
    (increment `inc`, renormalize at `cap`), evaluated chunk-wise (the
    reference scores adaptation speeds the same way,
    context_map_entropy.rs:1-554).  Top-nibble alphabet keeps this
    cheap, matching the reference's 16-ary CDFs."""
    if len(symbols) == 0:
        return 0.0
    syms = (symbols >> 4).astype(np.int64) if nibble else \
        symbols.astype(np.int64)
    k = 16 if nibble else 256
    freq = np.ones(k, np.float64)
    total_bits = 0.0
    for c0 in range(0, len(syms), chunk):
        part = syms[c0:c0 + chunk]
        hist = np.bincount(part, minlength=k)
        tot = freq.sum()
        p = freq / tot
        total_bits += -(hist * np.log2(p)).sum()
        freq = freq + hist * inc
        if freq.sum() > cap:
            freq = np.maximum(freq * 0.5, 1.0)
    return float(total_bits)


def detect_speeds(literals: np.ndarray):
    """Best (inc, max) speed pair for the context-map model and the
    stride model (reference -findspeed; best_speed_log,
    brotli_bit_stream.rs:197-218)."""
    best_cm, best_cm_cost = CANDIDATE_SPEEDS[0], float("inf")
    for inc, cap in CANDIDATE_SPEEDS:
        c = adaptive_cost(literals, max(inc, 1), cap)
        if c < best_cm_cost:
            best_cm_cost, best_cm = c, (inc, cap)
    # the stride model sees residual-like symbols; reuse the scorer on
    # the low nibbles (different view, same machinery)
    best_st, best_st_cost = CANDIDATE_SPEEDS[0], float("inf")
    low = (literals & 0x0F) << 4
    for inc, cap in CANDIDATE_SPEEDS[:8]:
        c = adaptive_cost(low, max(inc, 1), cap)
        if c < best_st_cost:
            best_st_cost, best_st = c, (inc, cap)
    return best_cm, best_st


def entropy_pyramid(data: np.ndarray, levels: int = 4,
                    max_stride: int = MAX_STRIDE):
    """Multi-resolution stride scoring (reference EntropyPyramid /
    EntropyTally, find_stride.rs:182-860): level L splits the input
    into 2^L equal buckets and scores strides 1..8 per bucket with the
    nibble-context conditional-entropy model, all buckets of a level
    in ONE vectorized histogram pass.  Returns
    {level: costs[num_buckets, max_stride]} in bits/byte — the
    per-region stride signal the flat scorer cannot see (a file that
    switches from text to float32 arrays mid-way gets stride 1 for the
    first half and stride 4 for the second)."""
    n = len(data)
    out = {}
    for level in range(levels + 1):
        nb = 1 << level
        if n < nb * (max_stride + 2):
            break
        blen = n // nb
        trimmed = data[:nb * blen].reshape(nb, blen)
        costs = np.zeros((nb, max_stride), np.float64)
        for stride in range(1, max_stride + 1):
            ctx = (trimmed[:, :-stride] >> 4).astype(np.int64)
            sym = trimmed[:, stride:].astype(np.int64)
            bucket = np.broadcast_to(
                np.arange(nb, dtype=np.int64)[:, None], ctx.shape)
            hist = np.zeros((nb, 16, 256), np.float64)
            np.add.at(hist, (bucket.ravel(), ctx.ravel(), sym.ravel()),
                      1)
            tot = hist.sum(axis=2, keepdims=True)
            p = (hist + 0.25) / (tot + 64.0)
            bits = -(hist * np.log2(p)).sum(axis=(1, 2))
            costs[:, stride - 1] = bits / max(1, blen - stride)
        out[level] = costs
    return out


def pyramid_stride_regions(data: np.ndarray, levels: int = 4):
    """Per-region best stride from the deepest pyramid level
    (reference EntropyTally::pick_best_stride shape): returns
    (region_len, strides[nb]) so callers can map stride decisions back
    onto input spans."""
    pyr = entropy_pyramid(data, levels)
    if not pyr:
        return len(data), np.array([1], np.int64)
    deepest = max(pyr)
    costs = pyr[deepest]
    strides = np.argmin(costs, axis=1) + 1
    nb = costs.shape[0]
    return len(data) // nb, strides


def stride_eval_per_block(literals: np.ndarray, block_types: np.ndarray,
                          num_types: int,
                          max_stride: int = MAX_STRIDE):
    """Per-block-type stride evaluation (reference StrideEval,
    stride_eval.rs:93-210: quality > 2 scores strides 1-8 against each
    literal block type's own CDF and picks per-type winners).
    literals/block_types are parallel arrays (one type id per literal,
    the splitter's assignment).  Returns (best_stride[num_types],
    costs[num_types, max_stride]) in bits/byte."""
    literals = np.asarray(literals, np.uint8)
    block_types = np.asarray(block_types, np.int64)
    costs = np.full((num_types, max_stride), 8.0, np.float64)
    for stride in range(1, max_stride + 1):
        if len(literals) <= stride:
            break
        ctx = (literals[:-stride] >> 4).astype(np.int64)
        sym = literals[stride:].astype(np.int64)
        # a literal pair only informs a type's CDF when both ends live
        # in the same block type (the reference resets the CDF at
        # block switches)
        t0 = block_types[:-stride]
        t1 = block_types[stride:]
        same = t0 == t1
        hist = np.zeros((num_types, 16, 256), np.float64)
        np.add.at(hist, (t1[same], ctx[same], sym[same]), 1)
        tot = hist.sum(axis=2, keepdims=True)
        p = (hist + 0.25) / (tot + 64.0)
        bits = -(hist * np.log2(p)).sum(axis=(1, 2))
        cnt = np.maximum(hist.sum(axis=(1, 2)), 1)
        costs[:, stride - 1] = bits / cnt
    return np.argmin(costs, axis=1) + 1, costs


def detect_prior(data: np.ndarray, best_stride: int,
                 stride_costs: list) -> str:
    """Pick the prior family (reference prior_eval.rs WhichPrior): CM
    when the previous-byte context wins, STRIDE when a stride predictor
    is clearly better, ADV when they are close (mixing pays)."""
    cm_cost = stride_costs[0]  # stride 1 == previous-byte context
    st_cost = min(stride_costs)
    if best_stride == 1 or cm_cost - st_cost < 0.05:
        return "CM"
    if cm_cost - st_cost > 0.3:
        return f"STRIDE{min(best_stride, 4)}"
    return "ADV"


def analyze(data: bytes, stride_detection_quality: int = 1,
            prior_bitmask_detection: int = 0) -> AnalysisResult:
    """Full analysis pass (the encoder's side-channel; CLI -findprior /
    -findspeed / -stride)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    if stride_detection_quality >= 2 or len(arr) > 1 << 20:
        sample = arr[: 1 << 20]
    else:
        sample = arr
    costs = stride_entropy_costs(sample)
    best_stride = int(np.argmin(costs)) + 1
    cm_speed, stride_speed = detect_speeds(sample)
    prior = detect_prior(sample, best_stride, costs) \
        if prior_bitmask_detection else "CM"
    region_len, region_strides = 0, None
    if stride_detection_quality >= 2:
        # advanced mode: the multi-resolution pyramid's per-region
        # picks (reference stride_detection_quality 2 runs the
        # EntropyPyramid; 1 keeps the flat tally)
        region_len, rs = pyramid_stride_regions(sample)
        region_strides = rs.tolist()
        # the global pick follows the region consensus when it is
        # decisive (the pyramid sees mixtures the flat scorer blurs)
        vals, cnts = np.unique(rs, return_counts=True)
        if cnts.max() * 2 > len(rs):
            best_stride = int(vals[np.argmax(cnts)])
    return AnalysisResult(best_stride=best_stride,
                          stride_costs=[round(c, 4) for c in costs],
                          cm_speed=cm_speed, stride_speed=stride_speed,
                          prior=prior, region_len=region_len,
                          region_strides=region_strides)
