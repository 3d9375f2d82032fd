"""Device block-split planning: chunked-entropy Lloyd iterations.

Torch counterpart of brotli_tpu/ops/split.py.  The literal block
splitter's entropy-clustering loop cost[chunk, type] = -hist_chunk .
log2 p_type runs on the device: chunk histograms, then per iteration
one [nch, alpha] x [alpha, k] product, an argmin and a one-hot
centroid update.  The products are plain float32 matmuls
(torch.matmul, as the JAX package left them to XLA); TF32 is switched
off so they run in full float32.  The run hysteresis and the
header-cost merge stay on the host (encode/metablock.py).

Traced (utils/trace.py), a call that reaches the Lloyd loop records
three spans inside its caller's: split.device (the copy in, the Lloyd
loop and the two copies back), split.hysteresis and split.merge.

The assignment decides output bytes, so the arithmetic follows the JAX
version step for step: float32 throughout, the same seeds, argmin
taking the first minimum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encode.metablock import (MIN_LENGTH_FOR_SPLITTING, SPLIT_PARAMS,
                                BlockSplit, _chunk_split, _hysteresis,
                                _merge_types)
from ..utils import trace

LLOYD_ITERS = 3


def linspace_seeds(nch: int, k: int) -> np.ndarray:
    """jnp.linspace(0, nch, k + 1).astype(int32) as the JAX version
    computes it: float32 steps iota / k scaled by nch, the endpoint
    exact, truncated to int32."""
    step = np.arange(k, dtype=np.float32) / np.float32(k)
    out = np.float32(0) * (np.float32(1) - step) + np.float32(nch) * step
    return np.concatenate([out, [np.float32(nch)]]).astype(np.int32)


def _lloyd_device(padded: torch.Tensor, alphabet_size: int, k: int,
                  chunk: int, iters: int, switch_pen: float):
    """Chunk histograms + Lloyd iterations on padded's device.

    padded: int32[nch * chunk] symbol stream, -1 = padding.
    Returns (assign int32[nch], cost float32[nch, k])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = padded.device
    f32 = torch.float32
    nch = padded.shape[0] // chunk
    # [nch, alpha] histograms by scatter-add; padding (-1) lands in one
    # extra slot that is dropped (counts are exact integers in float32)
    chunk_id = torch.arange(nch, device=dev).repeat_interleave(chunk)
    syms = padded.long()
    flat = torch.where(syms >= 0, chunk_id * alphabet_size + syms,
                       nch * alphabet_size)
    hist = torch.zeros(nch * alphabet_size + 1, dtype=f32, device=dev)
    hist.index_add_(0, flat, torch.ones(flat.shape[0], dtype=f32,
                                        device=dev))
    hist = hist[:-1].view(nch, alphabet_size)

    # evenly spaced chunk-group seeds (the host oracle's init)
    seeds = torch.from_numpy(linspace_seeds(nch, k)).to(dev)
    group = torch.clamp(
        torch.searchsorted(seeds[1:], torch.arange(
            nch, dtype=torch.int32, device=dev), right=True), 0, k - 1)
    types = torch.arange(k, device=dev)
    ginit = (group[:, None] == types[None, :]).to(f32)    # [nch, k]
    cent = ginit.T @ hist                                  # [k, alpha]

    def cost_of(cent):
        tot = cent.sum(dim=1, keepdim=True) + alphabet_size * 0.25
        logp = torch.log2((cent + 0.25) / tot)             # [k, alpha]
        return -(hist @ logp.T) + switch_pen               # [nch, k]

    assign = torch.zeros(nch, dtype=torch.int32, device=dev)
    for _ in range(iters):
        assign = torch.argmin(cost_of(cent), dim=1).to(torch.int32)
        oh = (assign[:, None] == types[None, :]).to(f32)
        cent = oh.T @ hist
    return assign, cost_of(cent)


def split_symbols_device(syms: np.ndarray, alphabet_size: int,
                         category: str, device: torch.device
                         ) -> BlockSplit:
    """Lloyd loop on `device`, run hysteresis + header-cost merge on
    the host."""
    p = SPLIT_PARAMS[category]
    n = len(syms)
    if n < MIN_LENGTH_FOR_SPLITTING:
        return BlockSplit.trivial(n)
    chunk = p["chunk"]
    nch = (n + chunk - 1) // chunk
    k = int(min(p["max_types"], max(1, nch // 3), 256))
    if k <= 1:
        return BlockSplit.trivial(n)
    # the chunk count rounds up to a power of two as in the JAX version
    # (which compiles once per bucket); all-padding chunks histogram to
    # zero rows and are sliced off below, but they shift the seeds, so
    # the padding is part of the result
    nch_pad = 1 << max(2, (nch - 1).bit_length())
    pad = nch_pad * chunk - n
    padded = np.concatenate(
        [np.asarray(syms, np.int32),
         np.full(pad, -1, np.int32)])
    switch_pen = p["switch_cost"] / max(1, chunk // 16)
    with trace.span("split.device"):
        assign_d, cost_d = _lloyd_device(
            torch.from_numpy(padded).to(device), alphabet_size, k, chunk,
            LLOYD_ITERS, switch_pen)
        assign = assign_d.cpu().numpy()[:nch].astype(np.int64)
        cost = cost_d.cpu().numpy()[:nch].astype(np.float64)

    with trace.span("split.hysteresis"):
        assign = _hysteresis(assign, cost, p["min_run"])

    # histograms for the merge (host; [nch, alpha] bincount over the
    # real chunks only)
    real = padded[:nch * chunk]
    chunk_id = np.repeat(np.arange(nch), chunk)
    valid = real >= 0
    flat = chunk_id[valid] * alphabet_size + real[valid].astype(np.int64)
    hist = np.bincount(flat, minlength=nch * alphabet_size) \
        .reshape(nch, alphabet_size).astype(np.float64)
    with trace.span("split.merge"):
        assign = _merge_types(assign, hist, k, p["switch_cost"],
                              p["header_cost"])
    return _chunk_split(assign, k, chunk, n)
