"""Static-dictionary probe of compress_gpu's spans: CUDA kernel + wrappers.

The kernel (csrc/dict_probe.cu, built with nvcc for sm_90a at first
use, loaded with ctypes) replaces no Pallas kernel: it moves
encode/static_dict.add_dictionary_matches, which the JAX package runs
in numpy on the host, onto the card beside the span's bytes the matcher
already holds there.  The host encoders and compress_mesh keep the
numpy probe.

  dict_probe(row, halo, real, min_pos, window)  the best identity or
        OmitLast candidate of each position of the row's span [halo,
        halo + real): the kernel on a CUDA row, the plain PyTorch
        version dict_probe_ref on a CPU row
  candidates(out)  the blocks' counts and their candidates, in
        position order
  merge_candidates(out, bl, bd, bsc)  the host's part: the candidates
        that score above the window's match, set into the per-position
        best arrays

The output is int64 [span + ctas] (span = len(row) - halo, ctas =
probe_plan(span)["ctas"]): the candidates of the span's THREADS-position
blocks, each block's in position order at the start of its THREADS
slots as k << 36 | wire length << 31 | length << 26 | dist (k the
position in the span, dist below 2^26), and the blocks' candidate
counts after the span.  A block's other slots are left unwritten (zero
in the plain version's output), so only candidates() compares two
outputs.  The host so reads the candidates alone.  LAUNCHES counts
kernel launches; the dictionary index is uploaded once a device and
kept.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..buildcache import CudaLibrary
from ..encode.static_dict import (DICT_HASH_BITS, DISTANCE_BIT_PENALTY,
                                  HASH_MUL32, MAX_WORD_LEN, PROBE_CHUNK,
                                  dict_index, omit_last_transform_ids)
from .matching import floor_log2

THREADS = 256           # csrc/dict_probe.cu kThreads: a block's slots
LBS = 135               # score per byte of length (the greedy tiers')
POS_SHIFT, WIRE_SHIFT, LEN_SHIFT = 36, 31, 26
NONE = -(1 << 63)       # no candidate (the plain version's)
MAX_SPAN = 1 << 27      # positions k fit the 27 bits above POS_SHIFT

#: kernel launches; reset and read by callers that check a run went
#: through the kernel
LAUNCHES = 0

_TABLES: dict = {}


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dict_probe_launch.argtypes = [vp] * 5 + [vp] + [ci] * 7 + [vp]
    lib.dict_probe_launch.restype = ci


LIB = CudaLibrary("dict_probe", _bind)


def probe_plan(span: int) -> dict:
    """The kernel's grid over a span of `span` positions: one thread a
    position, THREADS a CTA."""
    return dict(threads=THREADS, ctas=-(-span // THREADS))


def index_tables(dev: torch.device):
    """The greedy tiers' index on `dev`, made once a device: word bytes
    uint8 [entries, 24], each entry's L | size_bits[L] << 8 | word index
    << 16 as int32, the [2^15, 2] buckets as int32, and the transform
    ids of omit 0..9 (-1 none) as int64."""
    key = str(dev)
    if key not in _TABLES:
        word_bytes, word_len, word_idx, table, size_bits = dict_index()
        meta = word_len | size_bits[word_len] << 8 | word_idx << 16
        host = (torch.from_numpy(np.ascontiguousarray(word_bytes)),
                torch.from_numpy(meta.astype(np.int32)),
                torch.from_numpy(table.astype(np.int32)),
                torch.from_numpy(omit_last_transform_ids().copy()))
        _TABLES[key] = tuple(t.to(dev) for t in host)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    return _TABLES[key]


def dict_probe(row: torch.Tensor, halo: int, real: int, min_pos: int,
               window: int) -> torch.Tensor:
    """The candidates of the positions [halo, halo + real) of the uint8
    row (bytes at or past halo + real read as 0), int64 [span + ctas]
    as the module docstring lays them out.  Distances count from
    min_pos, capped at window."""
    global LAUNCHES
    span = row.shape[0] - halo
    if row.dtype != torch.uint8 or row.dim() != 1 \
            or not 0 < span <= MAX_SPAN or not 0 <= real <= span \
            or not 0 <= min_pos <= halo or not 0 <= window <= 1 << 24 \
            or row.shape[0] >= 1 << 31:
        raise ValueError(f"dict_probe: no probe of {real} positions at "
                         f"{halo} of a {row.dtype} row {tuple(row.shape)} "
                         f"(min_pos {min_pos}, window {window})")
    dev = row.device
    if dev.type == "cpu":
        return dict_probe_ref(row, halo, real, min_pos, window)
    if dev.type != "cuda":
        raise ValueError(f"dict_probe: unsupported device {dev}")
    word_bytes, meta, table, omit_ids = index_tables(dev)
    plan = probe_plan(span)
    lib = LIB.get()
    row = row.contiguous()
    out = torch.empty(span + plan["ctas"], dtype=torch.int64, device=dev)
    omit = (ctypes.c_int * len(omit_ids))(
        *omit_last_transform_ids().tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dict_probe_launch(
            row.data_ptr(), word_bytes.data_ptr(), meta.data_ptr(),
            table.data_ptr(), omit, out.data_ptr(), halo, real, span,
            min_pos, window, plan["threads"], plan["ctas"], stream)
    if err != 0:
        raise RuntimeError(f"dict_probe_launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def dict_probe_ref(row: torch.Tensor, halo: int, real: int, min_pos: int,
                   window: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on the row's device:
    add_dictionary_matches' [positions, 24] byte windows (here a view)
    and masked compare, PROBE_CHUNK positions at a time, for the span's
    positions only; then each block's candidates moved to its first
    slots."""
    dev = row.device
    span = row.shape[0] - halo
    ctas = probe_plan(span)["ctas"]
    best = torch.full((span,), NONE, dtype=torch.int64, device=dev)
    word_bytes, meta, table, omit_ids = index_tables(dev)
    word_len = (meta & 0xFF).long()
    size_bits = ((meta >> 8) & 0xFF).long()
    word_idx = (meta >> 16).long()
    text = torch.zeros(real + MAX_WORD_LEN, dtype=torch.uint8, device=dev)
    text[:real] = row[halo:halo + real]
    t64 = text.long()
    v = t64[:real] | t64[1:real + 1] << 8 | t64[2:real + 2] << 16 \
        | t64[3:real + 3] << 24
    h = ((v * HASH_MUL32) & 0xFFFFFFFF) >> (32 - DICT_HASH_BITS)
    windows = text.unfold(0, MAX_WORD_LEN, 1)
    for c0 in range(0, real, PROBE_CHUNK):
        c1 = min(c0 + PROBE_CHUNK, real)
        idx = torch.arange(c0, c1, device=dev)
        win = windows[c0:c1]
        base = torch.clamp(halo + idx - min_pos, max=window) + 1
        chunk = torch.full((c1 - c0,), NONE, dtype=torch.int64, device=dev)
        best_sc = torch.zeros(c1 - c0, dtype=torch.int64, device=dev)
        for slot in range(2):
            e = table[h[c0:c1], slot].long()
            ee = torch.clamp(e, min=0)
            wl = word_len[ee]
            eq = (win == word_bytes[ee]).to(torch.int32)
            m = torch.minimum(torch.minimum(eq.cumprod(1).sum(1), wl),
                              real - idx)
            omit = wl - m
            tr = omit_ids[torch.clamp(omit, max=len(omit_ids) - 1)]
            ok = (e >= 0) & (m >= 4) & (omit < len(omit_ids)) & (tr >= 0)
            dist = base + (torch.clamp(tr, min=0) << size_bits[ee]) \
                + word_idx[ee]
            sc = LBS * m - DISTANCE_BIT_PENALTY * floor_log2(dist).long()
            take = ok & ((chunk == NONE) | (sc > best_sc))
            chunk = torch.where(
                take, idx << POS_SHIFT | wl << WIRE_SHIFT | m << LEN_SHIFT
                | dist, chunk)
            best_sc = torch.where(take, sc, best_sc)
        best[c0:c1] = chunk
    # compaction: a candidate's slot is its block's start plus the
    # candidates before it in the block
    out = torch.zeros(span + ctas, dtype=torch.int64, device=dev)
    has = best != NONE
    k = torch.nonzero(has).flatten()
    block = k // THREADS
    counts = torch.bincount(block, minlength=ctas)
    start = torch.cumsum(counts, 0) - counts
    out[block * THREADS + torch.arange(len(k), device=dev) - start[block]] \
        = best[k]
    out[span:] = counts
    return out


def candidates(out: np.ndarray):
    """(counts, words) of dict_probe's output (int64 [span + ctas]):
    each block's candidate count, and the candidates of every block in
    position order."""
    # len(out) = span + ceil(span / THREADS), so ctas = ceil(len(out) /
    # (THREADS + 1))
    ctas = -(-len(out) // (THREADS + 1))
    counts = out[len(out) - ctas:]
    start = np.cumsum(counts) - counts
    n = int(counts.sum())
    return counts, out[np.repeat(np.arange(ctas) * THREADS - start, counts)
                       + np.arange(n)]


def merge_candidates(out: np.ndarray, bl: np.ndarray, bd: np.ndarray,
                     bsc: np.ndarray):
    """The host merge of dict_probe's output (int64 [span + ctas]): where
    a candidate scores above the window's match, it replaces it in bl,
    bd, bsc (int64 [real], in place).  Returns (isdict, wire, won): the
    walk's per-position dictionary flags and wire lengths, and the
    number of candidates taken."""
    e = candidates(out)[1]
    pos = e >> POS_SHIFT
    dist = e & ((1 << LEN_SHIFT) - 1)
    m = (e >> LEN_SHIFT) & 31
    sc = LBS * m - DISTANCE_BIT_PENALTY * np.floor(
        np.log2(dist)).astype(np.int64)
    take = sc > bsc[pos]
    won = pos[take]
    isdict = np.zeros(len(bl), bool)
    wire = bl.copy()
    bl[won] = m[take]
    bd[won] = dist[take]
    bsc[won] = sc[take]
    isdict[won] = True
    wire[won] = (e[take] >> WIRE_SHIFT) & 31
    return isdict, wire, len(won)
