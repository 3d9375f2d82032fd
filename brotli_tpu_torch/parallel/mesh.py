"""Multi-shard compression: shards with window halos, one catable stream
each, merged with BroCatli.

Counterpart of brotli_tpu/parallel/mesh.py, the JAX package's
CompressMulti analog (reference src/enc/threading/mod.rs:413, with
devices as workers).  A mesh here is a list of shard placements, one
torch.device a shard: make_mesh(n) puts shard i on visible CUDA card
i % torch.cuda.device_count(), so n shards share one card and run on it
in turn; make_mesh(n, device="cpu") puts every shard on the host, where
the kernels' plain PyTorch versions run.  The output depends only on the
number of shards (their length, halos and catable streams), never on
where they run, so it equals the JAX package's mesh of as many devices
byte for byte.  There is no fallback: too few cards still places the
shards on the cards there are, and no CUDA without device="cpu" raises.

The JAX package's psum of per-shard counts over the mesh becomes a sum
of the per-shard counts on shard 0's device: one process drives every
shard, so no collective is needed.  Its on-device compaction (cumsum,
scatter with mode="drop") is the same torch ops on the shard's device
(`_compact`).  Each shard's matcher is the port's fold
(ops/fold_cuda.best_matches_exact_p / exact8_p / exact9_p, the CUDA
kernel of csrc/fold.cu on a card); sharded_pipeline and match_pipeline
run ops/matching.best_matches_block (the fold form of csrc/
match_rounds.cu).  Serialization is the host's, through the port's
native runtime; where it is not in use (native_bridge.available()
false), capped lengths stay capped and every metablock is resolved and
stored in Python (store_meta_block_auto at quality >= 4, the trivial
store below), as in the JAX package (brotli_tpu/parallel/mesh.py:
363-401).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native_bridge as nb
from ..core import constants as C
from ..core.bitio import BitWriter
from ..device import resolve_device
from ..encode import bitstream as bstr
from ..encode.command import resolve_commands
from ..encode.encoder import POISONED_DISTANCE, compress
from ..encode.gpu_path import _halo_rows
from ..encode.match import greedy_parse, score_matches
from ..encode.metablock import choose_literal_context
from ..encode.params import EncoderParams
from ..encode.static_dict import add_dictionary_matches
from ..ops.fold_cuda import (best_matches_exact8_p, best_matches_exact9_p,
                             best_matches_exact_p)
from ..ops.matching import MIN_SCORE_DELTA, best_matches_block
from ..ops.parse import committed_parse
from .multi import _merge

SUB_BLOCK = 4096
LEN_SHIFT = 26


def make_mesh(n_devices: int | None = None, device=None) -> list:
    """n_devices shard placements.  device=None: shard i on visible CUDA
    card i % torch.cuda.device_count() (n_devices defaults to that
    count; without CUDA it raises); otherwise every shard on `device`
    ("cpu", or one card)."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"make_mesh: need at least one shard, not "
                         f"{n_devices}")
    if device is not None:
        return [resolve_device(device)] * (n_devices or 1)
    resolve_device(None)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    return [torch.device("cuda", i % count) for i in range(n)]


def shard_input(data: np.ndarray, n_shards: int,
                sub_block: int = SUB_BLOCK) -> np.ndarray:
    """Pad + reshape a byte buffer to [n_shards, shard_len] with
    shard_len a multiple of sub_block (zero-padded tail)."""
    n = len(data)
    shard_len = -(-n // n_shards)
    shard_len = -(-shard_len // sub_block) * sub_block
    padded = np.zeros(n_shards * shard_len, dtype=np.uint8)
    padded[:n] = data
    return padded.reshape(n_shards, shard_len)


def _compact(keep: torch.Tensor, maxc: int, *values: torch.Tensor):
    """The JAX package's compaction (cumsum, then a scatter with
    mode="drop"): each value's entries where keep holds, in order, in a
    zero-filled int32 [maxc] vector, those past maxc dropped; and their
    count min(sum(keep), maxc) as a 0-d int32 tensor.  Dropped entries
    land in a slot past the end, which is cut off."""
    idx = torch.cumsum(keep, 0, dtype=torch.int32) - 1
    tgt = torch.where(keep, idx, maxc).clamp_(max=maxc).long()
    outs = []
    for v in values:
        out = torch.zeros(maxc + 1, dtype=torch.int32, device=keep.device)
        out.index_put_((tgt,), v.to(torch.int32))
        outs.append(out[:maxc])
    count = torch.clamp(keep.sum(dtype=torch.int32), max=maxc)
    return (*outs, count)


def _rows_on(mesh: list, blocks) -> list:
    """Row i of blocks ([n_shards, L] uint8, numpy or torch) on shard i's
    device."""
    if len(blocks) != len(mesh):
        raise ValueError(f"{len(blocks)} rows for a mesh of {len(mesh)} "
                         "shards")
    return [torch.as_tensor(b if torch.is_tensor(b)
                            else np.array(b, dtype=np.uint8)).to(dev)
            for b, dev in zip(blocks, mesh)]


def _gather(mesh: list, per_shard: list):
    """Stack each output over the shards on shard 0's device; the last
    output, a count a shard, also summed there (the psum)."""
    home = mesh[0]
    outs = [torch.stack([s[j].to(home) for s in per_shard])
            for j in range(len(per_shard[0]))]
    return (*outs, outs[-1].sum(dtype=torch.int32))


def sharded_pipeline(mesh: list, window_size: int = (1 << 22) - 16,
                     k: int = 4, k8: int = 2):
    """The multi-shard step: [n_shards, shard_len] uint8 -> per position
    (visited, take, dist), each [n_shards, shard_len] on shard 0's
    device, and the total command count.  Each shard is matched
    (best_matches_block) and parsed (committed_parse) on its own device
    with a shard-local window."""

    def step(blocks):
        per = []
        for data in _rows_on(mesh, blocks):
            best_len, best_dist, best_score = best_matches_block(
                data, window_size, k=k, k8=k8)
            visited, take = committed_parse(best_len, best_score, SUB_BLOCK)
            per.append((visited, take, best_dist,
                        (visited & (take >= 2)).sum(dtype=torch.int32)))
        visited, take, dist, _, total = _gather(mesh, per)
        return visited, take, dist, total

    return step


def match_pipeline(mesh: list, window_size: int, k: int = 4, k8: int = 2):
    """Multi-shard match finding with compaction on each shard's device:
    [n_shards, shard_len] uint8 -> compact (pos, len, dist) a shard
    (int32 [n_shards, shard_len // 8], zero past the shard's count),
    the counts [n_shards] and their total."""

    def step(blocks):
        per = []
        for data in _rows_on(mesh, blocks):
            n = data.shape[0]
            best_len, best_dist, best_score = best_matches_block(
                data, window_size, k=k, k8=k8)
            pos = torch.arange(n, dtype=torch.int32, device=data.device)
            per.append(_compact(best_score > MIN_SCORE_DELTA, n // 8, pos,
                                best_len, best_dist))
        return _gather(mesh, per)

    return step


def _halo_shard(row: torch.Tensor, min_pos: int, window_size: int,
                halo: int, k: int, k8: int, rounds: int, variant: str):
    """One halo-extended row's matcher (the fold of the tier) and the
    compaction of its shard region: (cpos, clen, cdist, count) on the
    row's device."""
    n = row.shape[0]
    if variant == "exact9":
        packed = best_matches_exact9_p(row, window_size, k=k,
                                       k_short=max(k8, 8), rounds=rounds,
                                       min_pos=min_pos)
    elif k8 > 0:
        # the host matcher's 8-byte secondary table: in sorted space
        # that coverage is the two-key fold's
        packed = best_matches_exact8_p(row, window_size, k=k,
                                       rounds=max(rounds, 2),
                                       min_pos=min_pos)
    else:
        packed = best_matches_exact_p(row, window_size, k=k, rounds=rounds,
                                      min_pos=min_pos)
    pos = torch.arange(n, dtype=torch.int32, device=row.device)
    keep = (packed != 0) & (pos >= halo)
    return _compact(keep, n - halo, pos, packed >> LEN_SHIFT,
                    packed & ((1 << LEN_SHIFT) - 1))


def halo_pipeline(mesh: list, window_size: int, halo: int, k: int = 8,
                  k8: int = 4, rounds: int = 2, variant: str = "exact"):
    """Multi-shard match finding over halo-extended rows: (rows
    [n_shards, halo + shard_len] uint8, min_pos [n_shards]) -> compact
    (pos, len, dist) of each shard region (int32 [n_shards, shard_len]),
    the counts [n_shards] and their total.  Each row is the shard
    preceded by the true bytes before it; min_pos masks the zero-filled
    part of a halo."""

    def step(rows, min_pos):
        per = [_halo_shard(row, int(mp), window_size, halo, k, k8, rounds,
                           variant)
               for row, mp in zip(_rows_on(mesh, rows), min_pos)]
        return _gather(mesh, per)

    return step


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A host copy of t: pinned and not yet complete on a card (the
    caller waits on an event), a plain copy on the host."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def compress_mesh(data, mesh: list | None = None, n_shards: int = None,
                  quality: int = 9, lgwin: int = 22, lgblock: int = 0,
                  device=None, stats: dict | None = None) -> bytes:
    """Multi-shard compression, byte-identical to brotli_tpu's
    compress_mesh over a mesh of as many devices: the input is cut into
    len(mesh) shards of a multiple of 4096 bytes, each preceded by a
    halo of the window-size bytes before it; each shard's matcher runs
    on its device (q <= 6: best_matches_exact_p, k = 32, rounds = 4;
    q > 6: best_matches_exact9_p, k = k_short = 16, rounds = 4), the
    host serializes each shard as a catable stream at the quality tier,
    and BroCatli merges them.

    mesh: from make_mesh; None = make_mesh(n_shards, device).
    stats: pass a dict to receive wall_s, device_wait_s (the host
    blocked on the devices' results) and device_fraction = device_wait /
    wall.  Inputs shorter than n_shards * 4096 bytes go to the host
    encoder, compress(data, quality=quality, lgwin=lgwin), as in the JAX
    package (lgblock is not passed); stats is then left as it was."""
    t_start = time.perf_counter()
    raw = np.frombuffer(bytes(data), dtype=np.uint8)
    if mesh is None:
        mesh = make_mesh(n_shards, device)
    n_dev = len(mesh)
    if len(raw) < n_dev * SUB_BLOCK:
        return compress(bytes(data), quality=quality, lgwin=lgwin)
    params = EncoderParams(quality=quality, lgwin=lgwin,
                           lgblock=lgblock).sanitize(None)

    n = len(raw)
    shard_len = -(-n // n_dev)
    shard_len = -(-shard_len // SUB_BLOCK) * SUB_BLOCK
    # the halo covers the whole window: every cross-shard match the
    # reference's CompressMulti can encode is visible to the matcher
    halo = -(-min(params.window_size, n) // SUB_BLOCK) * SUB_BLOCK
    rows, min_pos = _halo_rows(raw, shard_len, halo)
    n_real = len(rows)   # shards with bytes of their own

    knobs = dict(k=32, k8=0, rounds=4, variant="exact") \
        if params.quality <= 6 \
        else dict(k=16, k8=16, rounds=4, variant="exact9")
    # every shard's device work is queued first; its results come back
    # to pinned buffers behind an event, so the host serializes shard i
    # while the devices match the shards after it
    pending = []
    for i in range(n_real):
        dev = mesh[i]
        row = torch.from_numpy(rows[i]).to(dev)
        outs = [_pinned(t) for t in _halo_shard(
            row, int(min_pos[i]), params.window_size, halo, **knobs)]
        ev = None
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        pending.append((ev, outs))

    pieces = []
    device_wait = 0.0
    for i in range(n_real):
        ev, outs = pending[i]
        t0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        device_wait += time.perf_counter() - t0
        cpos, clen, cdist, count = [t.numpy() for t in outs]
        pending[i] = None
        real = min(shard_len, n - i * shard_len)
        row = rows[i]
        cnt = int(count)
        pos = cpos[:cnt].astype(np.int64) - halo   # shard-relative
        keep = (pos >= 0) & (pos < real)
        bl = np.zeros(real, np.int64)
        bd = np.zeros(real, np.int64)
        bl[pos[keep]] = clen[:cnt][keep]
        bd[pos[keep]] = cdist[:cnt][keep]
        bsc = score_matches(bl, bd, row[:halo + real], halo,
                            knobs["rounds"], knobs["variant"] == "exact9")
        isd = np.zeros(real, bool)
        bwire = bl.copy()
        if i == 0:
            # shard 0 is appendable and may reference the static
            # dictionary (catable shards must not); its halo is zero
            # fill, so the probe runs on the shard region alone, where
            # dictionary pseudo-distances see the true positions
            add_dictionary_matches(row[halo:halo + real], 0,
                                   params.window_size, 135, bl, bd, bsc,
                                   isd, bwire)

        w = BitWriter()
        bstr.write_stream_header(w, params.lgwin)
        start = 0
        cache = list(C.INITIAL_DISTANCE_CACHE)
        if i > 0:
            cache = [POISONED_DISTANCE] * 4
            hk = min(2, real)
            bstr.store_uncompressed_meta_block(
                w, row[halo:halo + hk].tobytes())
            start = hk
        if real - start > 0:
            # shard 0 parses without a dictionary region, so absolute
            # positions (and dictionary eligibility) are exact
            dlen = halo if i > 0 else 0
            region = row[:halo + real] if i > 0 \
                else row[halo:halo + real]
            _serialize_shard(w, region, dlen, start, real, bl, bd, bsc,
                             isd, bwire, params, cache)
        bstr.write_empty_last_meta_block(w)
        pieces.append(w.getvalue())
    out = _merge(pieces)
    if stats is not None:
        wall = time.perf_counter() - t_start
        stats.update(wall_s=wall, device_wait_s=device_wait,
                     device_fraction=device_wait / wall if wall else 0.0)
    return out


def _serialize_shard(w, region, dlen, start, real, bl, bd, bsc, isd,
                     bwire, params, cache):
    """One shard's parse as lgblock-sized metablocks through the native
    store (a metablock is capped at 2^24 bytes by the format).  The
    distance cache rolls across metablocks; a metablock that would
    expand is stored uncompressed.  Where the fused native store refuses
    a block for its buffer, or the runtime is not in use, the commands
    are resolved here and stored as the JAX package stores them
    (brotli_tpu/parallel/mesh.py:377-400): store_meta_block_or_raw at
    the quality tier."""
    span = 1 << params.lgblock
    bounds = list(range(start + span, real, span)) + [real]
    segs = greedy_parse(region, bl, bd, bsc, bounds, dict_len=dlen,
                        pos0=start, initial_cache=tuple(cache),
                        best_isdict=isd, window_size=params.window_size,
                        best_wire=bwire)
    mb_start = start
    for gi, (ins, cps, dst, adv) in enumerate(segs):
        mb_end = bounds[gi]
        mlen = mb_end - mb_start
        if mlen <= 0:
            continue
        res = None
        if nb.available():
            ctx_mode, nlc, smap = choose_literal_context(
                region, dlen + mb_start, mlen, params.quality, params.mode,
                real)
            res = nb.encode_metablock(
                region, dlen + mb_start, mlen, False, ins, cps, dst, adv,
                cache, params.window_size, 0, 0, params.dist.alphabet_size,
                max(params.quality, 4), ctx_mode, nlc, smap,
                C.CONTEXT_LUT0[ctx_mode], C.CONTEXT_LUT1[ctx_mode])
        new_cache = bstr.append_native(w, res, mlen)
        if new_cache is not None:
            cache[:] = new_cache
        elif res is not None:
            bstr.store_raw(w, region[dlen + mb_start:dlen + mb_end], False)
        else:
            cmds, new_cache = resolve_commands(
                ins, cps, dst, params.dist, advance=adv,
                initial_cache=cache, pos_offset=dlen + mb_start,
                window_size=params.window_size)
            if bstr.store_meta_block_or_raw(
                    w, region, dlen + mb_start, mlen, cmds, params.dist,
                    params.quality, mlen, 0, False):
                cache[:] = new_cache
        mb_start = mb_end
