"""Device compress path for q0/q1: hashed match finding on the GPU, the
walk and a trivial metablock store on the host.

Counterpart of brotli_tpu/encode/fast.py's compress_fast.  Per shard of
up to SHARD bytes (one metablock each) the device runs the hashed
block matcher (ops/matching.best_matches_block: two hash tables, the
match_rounds CUDA kernel for the lengths) and compacts the accepted
candidates (score > 100) into at most n/8 records, so only those cross
to the host.  The host runs the native greedy walk, resolves the
commands natively and stores one metablock with one prefix code per
category (encode/bitstream.store_meta_block_trivial), or the raw bytes
where that is smaller.

The distance cache carries from one shard's metablock to the next, as
a decoder carries it.  brotli_tpu's compress_fast restarts it at every
shard, so its streams of more than one shard do not decode; on inputs
of one shard (up to SHARD bytes) the two streams are byte-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.bitio import BitWriter
from ..device import resolve_device
from ..ops.matching import MIN_SCORE_DELTA, best_matches_block
from . import bitstream as bs
from .command import resolve_commands
from .match import greedy_parse, score_matches
from .params import EncoderParams

SUB_BLOCK = 4096
SHARD = 1 << 22  # one metablock per shard


def _gpu_match_compact(data: torch.Tensor, window_size: int, k: int = 2,
                       k8: int = 1):
    """Batched match finding + compaction of the accepted candidates.
    Returns (cpos, clen, cdist) int32 [n // 8] and count: record i <
    count is the i-th accepted position in order; accepted positions
    past the n // 8 records are dropped (they parse as literals) and
    count = min(accepted, n // 8)."""
    n = data.shape[0]
    best_len, best_dist, best_score = best_matches_block(
        data, window_size, k=k, k8=k8)
    keep = best_score > MIN_SCORE_DELTA
    maxc = n // 8
    idx = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    # every record that is not kept, or lies past the buffer, goes to
    # the dump slot maxc, which is cut off
    tgt = torch.where(keep & (idx < maxc), idx, maxc).long()
    pos = torch.arange(n, dtype=torch.int32, device=data.device)
    recs = torch.zeros((3, maxc + 1), dtype=torch.int32, device=data.device)
    recs.scatter_(1, tgt.expand(3, n),
                  torch.stack([pos, best_len, best_dist]))
    count = torch.clamp(keep.sum(), max=maxc)
    return recs[0, :maxc], recs[1, :maxc], recs[2, :maxc], count


def compress_fast(data, lgwin: int = 22, quality: int = 1,
                  device=None) -> bytes:
    """One-shot q0/q1 device-path compress, byte-identical to
    brotli_tpu's compress_fast at the same settings on inputs of one
    shard (see the module docstring for longer ones).

    device: None = CUDA (raises when there is none); "cpu" runs the
    same path with the kernel's plain PyTorch version."""
    dev = resolve_device(device)
    raw = np.frombuffer(bytes(data), dtype=np.uint8)
    params = EncoderParams(quality=quality, lgwin=lgwin).sanitize(len(raw))
    w = BitWriter()
    bs.write_stream_header(w, params.lgwin)
    n = len(raw)
    if n == 0:
        bs.write_empty_last_meta_block(w)
        return w.getvalue()

    cache = list(C.INITIAL_DISTANCE_CACHE)
    for s0 in range(0, n, SHARD):
        s1 = min(s0 + SHARD, n)
        shard = raw[s0:s1]
        m = len(shard)
        m_main = (m // SUB_BLOCK) * SUB_BLOCK
        bl = np.zeros(m, np.int64)
        bd = np.zeros(m, np.int64)
        # a shard shorter than one sub-block finds no matches (the
        # reference's behaviour): it parses as literals
        if m_main >= SUB_BLOCK:
            x = torch.from_numpy(shard[:m_main].copy()).to(dev)
            cpos, clen, cdist, count = _gpu_match_compact(
                x, params.window_size)
            count = int(count)
            cpos = cpos[:count].cpu().numpy().astype(np.int64)
            bl[cpos] = clen[:count].cpu().numpy()
            bd[cpos] = cdist[:count].cpu().numpy()
        # scores recomputed on the host (cheaper than shipping them)
        bsc = score_matches(bl, bd)
        segs = greedy_parse(shard, bl, bd, bsc, [m], dict_len=0, pos0=0,
                            initial_cache=tuple(cache),
                            best_isdict=np.zeros(m, bool),
                            window_size=params.window_size, best_wire=bl)
        ins, cps, dst, adv = segs[0]
        cmds, new_cache = resolve_commands(
            ins, cps, dst, params.dist, advance=adv, initial_cache=cache,
            window_size=params.window_size)
        # quality 0: the trivial store, as brotli_tpu's at any quality
        if bs.store_meta_block_or_raw(w, shard, 0, m, cmds, params.dist, 0,
                                      m, params.mode, s1 == n):
            cache = new_cache
    return w.getvalue()
