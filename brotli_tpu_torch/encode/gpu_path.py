"""Device compress path for q2-q9: match finding on the GPU, parse and
serialization on the host.

Counterpart of brotli_tpu/encode/tpu_path.py's compress_tpu.  For each
metablock span the device runs the content-sorted matcher
(`_match_dense`: stable sort(s) + the CUDA fold kernel) over the span
plus a window-covering halo of preceding bytes and returns its results
in sorted space, and the static-dictionary probe
(ops/dict_probe_cuda.py) returns each span position's best dictionary
candidate; the host inverts the matcher's results (native invert_perm32
/ invert_merge32), extends length-capped matches, merges the dictionary
candidates that beat them, runs the native greedy walk, plans the
literal block split on the device (ops/split.py) and stores through the
native metablock serializer.

max_device=True also commits the parse on the device
(`_match_parse_dense`: the fold with 6 attested rounds, then
ops/parse.committed_parse's pointer doubling over 4096-byte
sub-blocks); the host only assembles commands and stores them, at a
ratio cost (copies cap at 24 bytes, parses cut at sub-block seams, no
static dictionary).  A copy is cut at the span's last real byte as at
a seam, after it is scored: the zero fill after a short last span is
not data.

Where the host runtime is not in use (native_bridge.available()
false) the device leg is unchanged, and the host leg takes the JAX
package's no-runtime route (tpu_path.py:413-432): no extension of
capped lengths, the Python greedy walk, resolve_commands and the
pure-Python planner and store (store_meta_block_auto), a block larger
than 8 * len + 40 bits stored uncompressed.  The matcher then always
inverts on the device: the host inversion is the runtime's.  The JAX
package calls it unguarded there and raises (ROADMAP queue 3).

Pipelining: up to three dispatches are in flight on one CUDA stream.
A dispatch copies its row from pinned memory, runs the matcher and the
dictionary probe and copies the results back into pinned buffers, all
non-blocking, and records one event; the host waits on that event only
when it needs the span, so it serializes span j while the device
computes j+1 and j+2.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import native_bridge as nb
from ..core import constants as C
from ..core.bitio import BitWriter
from ..device import resolve_device
from ..ops.dict_probe_cuda import dict_probe, merge_candidates
from ..ops.fold_cuda import (best_matches_exact8_p, best_matches_exact9_p,
                             best_matches_exact_p, merge_exact9)
from ..ops.matching import floor_log2
from ..ops.parse import committed_parse
from ..ops.split import split_symbols_device
from ..utils import trace
from . import bitstream as bs
from .command import resolve_commands
from .match import greedy_parse, score_matches
from .metablock import choose_literal_context
from .params import EncoderParams

LEN_SHIFT = 26  # dist < 2^26 covers lgwin <= 24 (dist < 2^24 + slack)
_MAX_INFLIGHT = 3
DICT_COUNTERS = ("dict.positions", "dict.won")
PARSE_COUNTERS = ("parse.positions", "parse.copied")
MATCH_COUNTERS = ("match.positions", "match.short_won")


def _match_dense(row: torch.Tensor, min_pos: int, window_size: int,
                 halo: int, k: int, k8: int, rounds: int,
                 variant: str = "exact", device_invert: bool = False,
                 short_won=None):
    """Device matcher over one row.  Sorted-space form (default): the
    tier wrapper's (pos_s, packed_s) -- exact9: both folds' (pos_s,
    packed_s, score_s) -- for the host to invert.  device_invert=True
    inverts on the device and returns the span's packed
    (len << 26 | dist) alone.  short_won=(lo, hi), exact9 only: one
    more output, last, a one-element count of the row positions in
    [lo, hi) whose merged match comes from the short fold (its score
    strictly beats the exact8 fold's, the merge's rule)."""
    kw = dict(k=k, rounds=rounds, min_pos=min_pos, len_shift=LEN_SHIFT)
    if variant == "exact9":
        out = best_matches_exact9_p(row, window_size, k_short=max(k8, 8),
                                    invert=False, **kw)
        if device_invert or short_won is not None:
            packed, won = merge_exact9(out)
            if device_invert:
                out = (packed[halo:],)
            if short_won is not None:
                lo, hi = short_won
                out = (*out, won[lo:hi].sum().reshape(1))
        return out
    fn = best_matches_exact8_p if variant == "exact8" else \
        best_matches_exact_p
    if device_invert:
        return (fn(row, window_size, **kw)[halo:],)
    return fn(row, window_size, invert=False, **kw)[:2]


def _pick_device_invert(dev: torch.device) -> bool:
    """Sorted-space outputs (the host applies the permutation) keep the
    device's work smallest but bring 2-6 full-row arrays back; the
    on-device inversion brings one span-sized array.  The on-device
    form is taken only over a slow link (< 200 MB/s round trip of 1
    MiB).  BROTLI_TPU_TORCH_DEVICE_INVERT=0/1 overrides; on the CPU
    there is no link and the sorted-space form is used."""
    ev = os.environ.get("BROTLI_TPU_TORCH_DEVICE_INVERT")
    if ev:
        return ev not in ("0", "false", "no")
    if dev.type != "cuda":
        return False
    probe = torch.zeros(1 << 20, dtype=torch.uint8).pin_memory()
    probe.to(dev).cpu()  # warm
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    probe.to(dev).cpu()
    bw = (1 << 20) / max(time.perf_counter() - t0, 1e-9) / 1e6
    return bw < 200.0


def _device_knobs(quality: int):
    """Per-tier matcher knobs (the JAX package's values): the speed
    tiers attest 8 bytes (rounds=2) and the host extends at the cap;
    q9 attests 16 bytes and adds the short fold."""
    if quality <= 6:
        return dict(k=32, k8=0, rounds=2, variant="exact")
    if quality <= 8:
        return dict(k=16, k8=0, rounds=2, variant="exact8")
    return dict(k=16, k8=16, rounds=4, variant="exact9")


def _match_parse_dense(row: torch.Tensor, min_pos: int, window_size: int,
                       halo: int, k: int, rounds: int, real: int):
    """max_device matcher: the fold, inverted on the device, then the
    greedy parse committed on the device over 4096-byte sub-blocks.
    A copy is cut at the span's `real` bytes as at a seam (after the
    score; in a full span the seam cut is the same).  Returns (visited,
    take, dist) for the row's [halo:] span."""
    packed = best_matches_exact_p(row, window_size, k=k, rounds=rounds,
                                  min_pos=min_pos,
                                  len_shift=LEN_SHIFT)[halo:]
    with trace.span("pipe.parse"):
        bl = packed >> LEN_SHIFT
        bd = packed & ((1 << LEN_SHIFT) - 1)
        logd = floor_log2(torch.clamp(bd, min=1))
        score = torch.where(bl > 0, 135 * bl - 30 * logd, 0)
        left = real - torch.arange(packed.shape[0], dtype=torch.int32,
                                   device=packed.device)
        bl = torch.clamp(torch.minimum(bl, left), min=0)
        visited, take = committed_parse(bl, score, 4096)
    return visited, take, bd


def _commands_from_parse(visited, take, dist, real):
    """(ins, cps, dst, adv) of a device commitment, vectorized."""
    vis = np.nonzero(visited[:real])[0]
    tk = take[vis]
    cp = tk >= 2
    cp_pos = vis[cp].astype(np.int64)
    cp_len = tk[cp].astype(np.int64)
    cp_dist = dist[cp_pos].astype(np.int64)
    prev_end = np.concatenate([[0], cp_pos + cp_len])
    ins = cp_pos - prev_end[:-1]
    tail = real - (prev_end[-1] if len(cp_pos) else 0)
    if tail > 0:
        ins = np.concatenate([ins, [tail]])
        cp_len = np.concatenate([cp_len, [0]])
        cp_dist = np.concatenate([cp_dist, [1]])
    return ins, cp_len, cp_dist, cp_len.copy()


def _host_parse(sorted_out, dict_out, row, halo, real, dlen, region,
                knobs, window_size, cache):
    """The host leg of one span's matches: invert (or merge) the
    device's sorted-space outputs, extend length-capped matches, merge
    the device's static-dictionary candidates and run the greedy walk.
    Returns the walk's segments."""
    with trace.span("host_parse.invert"):
        if len(sorted_out) == 1:   # device_invert: position space
            packed = sorted_out[0][:real].astype(np.int64)
        else:
            if len(sorted_out) == 6:  # exact9: two folds, host merge
                packed = nb.invert_merge32(*sorted_out)
            else:
                packed = nb.invert_perm32(*sorted_out)
            packed = packed[halo:halo + real].astype(np.int64)
        bl = packed >> LEN_SHIFT
        bd = packed & ((1 << LEN_SHIFT) - 1)
    with trace.span("host_parse.extend"):
        # every reported length is byte-attested by the kernel's
        # chunk-value payloads, so extension resumes at the cap
        bsc = score_matches(bl, bd, row[:halo + real], halo,
                            knobs["rounds"], knobs["variant"] == "exact9")
    with trace.span("host_parse.dict_probe"):
        # the dictionary candidates that beat the window's match
        isdict, wire, won = merge_candidates(dict_out, bl, bd, bsc)
        trace.count("dict.positions", real)
        trace.count("dict.won", won)
    with trace.span("host_parse.walk"):
        return greedy_parse(region, bl, bd, bsc, [real], dict_len=dlen,
                            pos0=0, initial_cache=tuple(cache),
                            best_isdict=isdict, window_size=window_size,
                            best_wire=wire)


class _Pipeline:
    """Up to _MAX_INFLIGHT matcher dispatches in flight.  On CUDA each
    dispatch runs on one side stream: pinned row -> device, matcher,
    results -> pinned buffers, one event.  Slots rotate over
    _MAX_INFLIGHT + 1 pinned buffer sets, so the set the host is
    reading is never the target of a dispatch in flight.  On the CPU a
    dispatch runs at once."""

    def __init__(self, rows, dev, run):
        self.rows = rows
        self.dev = dev
        self.run = run
        self.inflight = {}
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.stream = torch.cuda.Stream(dev)
            nslots = _MAX_INFLIGHT + 1
            self.pin_in = [torch.empty(rows.shape[1], dtype=torch.uint8)
                           .pin_memory() for _ in range(nslots)]
            self.pin_out = [None] * nslots

    def dispatch(self, j):
        with trace.span("pipe.dispatch"):
            if not self.cuda:
                self.inflight[j] = (None, self.run(
                    j, torch.from_numpy(self.rows[j])))
                return
            slot = j % (_MAX_INFLIGHT + 1)
            self.pin_in[slot].numpy()[:] = self.rows[j]
            with torch.cuda.stream(self.stream):
                row_d = self.pin_in[slot].to(self.dev, non_blocking=True)
                outs = self.run(j, row_d)
                bufs = self.pin_out[slot]
                if bufs is None or [b.shape for b in bufs] != \
                        [o.shape for o in outs]:
                    with trace.span("entry.call_setup"):
                        bufs = self.pin_out[slot] = [
                            torch.empty(o.shape, dtype=o.dtype).pin_memory()
                            for o in outs]
                for b, o in zip(bufs, outs):
                    b.copy_(o, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            self.inflight[j] = (ev, bufs)

    def wait(self, j):
        """Block until dispatch j's results are on the host; returns
        them as numpy arrays (views of the slot's pinned buffers)."""
        with trace.span("pipe.wait"):
            ev, outs = self.inflight.pop(j)
            if ev is not None:
                ev.synchronize()
            return [o.numpy() for o in outs]


def _halo_rows(raw: np.ndarray, span: int, halo: int):
    """The input as fixed-shape rows, one a span: (rows [ceil(n / span),
    halo + span] uint8, min_pos [rows]).  Row j holds span j at [halo:]
    (zero fill past the input's end) and the up to halo bytes before it
    right before; min_pos[j] is where those start (zero fill below)."""
    n = len(raw)
    rows = np.zeros((-(-n // span), halo + span), dtype=np.uint8)
    min_pos = np.zeros(len(rows), np.int32)
    for j, s0 in enumerate(range(0, n, span)):
        fill = min(s0, halo)
        rows[j, halo - fill:halo + min(span, n - s0)] = \
            raw[s0 - fill:s0 + span]
        min_pos[j] = halo - fill
    return rows, min_pos


def _store_span(w, region, dlen, real, seg, params, n, is_last, cache, dev):
    """One span's commands (ins, cps, dst, adv) as a metablock of
    region[dlen:dlen + real]: the literal context, the literal block
    split on the device, the native store, the block stored uncompressed
    where the store refused or grew it.  Without the runtime, the JAX
    package's route: the commands resolved, then store_meta_block_or_raw
    at quality >= 4.  Returns the distance cache after the span."""
    ins, cps, dst, adv = seg
    if not nb.available():
        with trace.span("store.metablock"):
            cmds, new_cache = resolve_commands(
                ins, cps, dst, params.dist, advance=adv, initial_cache=cache,
                pos_offset=dlen, window_size=params.window_size)
            if bs.store_meta_block_or_raw(
                    w, region, dlen, real, cmds, params.dist,
                    max(params.quality, 4), n, params.mode, is_last):
                return new_cache
            return cache
    with trace.span("store.context"):
        ctx_mode, nlc, smap = choose_literal_context(
            region, dlen, real, params.quality, params.mode, n)
    # literal block split planned on the device; a failure raises
    ext_split = None
    with trace.span("store.literals"):
        lit_stream = bs.extract_literals(region, dlen, ins, adv)
    if len(lit_stream) >= 128:
        with trace.span("store.split"):
            sp = split_symbols_device(lit_stream.astype(np.int64), 256,
                                      "literal", dev)
        if sp.num_types > 1:
            ext_split = (sp.types.astype(np.int32), sp.num_types)
    with trace.span("store.metablock"):
        res = nb.encode_metablock(
            region, dlen, real, is_last, ins, cps, dst, adv, cache,
            params.window_size, 0, 0, params.dist.alphabet_size,
            max(params.quality, 4), ctx_mode, nlc, smap,
            C.CONTEXT_LUT0[ctx_mode], C.CONTEXT_LUT1[ctx_mode],
            ext_lit_split=ext_split)
        new_cache = bs.append_native(w, res, real)
    if new_cache is not None:
        return new_cache
    with trace.span("store.raw"):
        bs.store_raw(w, region[dlen:dlen + real], is_last)
    return cache


def compress_gpu(data, quality: int = 9, lgwin: int = 22, mode: int = 0,
                 span: int | None = None, stats: dict | None = None,
                 max_device: bool = False, device=None) -> bytes:
    """One-shot device-path compress for q2-q9, byte-identical to
    brotli_tpu's compress_tpu at the same settings.

    max_device: commit the greedy parse on the device too (see the
    module docstring); span must then be a multiple of 4096.

    device: None = CUDA (raises when there is none); "cpu" runs the
    same path with the fold's plain PyTorch version.

    stats: pass a dict to trace the call (utils/trace.py; with None
    nothing is recorded).  It receives
      wall_s         the whole call, in seconds
      device_wait_s  the host blocked on the device (the pipe.wait spans)
      spans          (name, parent index, t0_ns, t1_ns) on the
                     perf_counter_ns clock, parent -1 for the root:
          compress_gpu           the call
          entry.rows             the input's fixed-shape rows
          entry.call_setup       the link probe, the pipeline's stream
                                 and pinned buffers (also inside
                                 pipe.dispatch: a slot's first output
                                 buffers)
          pipe.dispatch          the pinned row copy and the enqueue (on
                                 the CPU: the matcher itself)
            pipe.parse             max_device: the scores and
                                   committed_parse (enqueued on CUDA)
          pipe.wait              the wait on a dispatch's event
          host_parse             the host leg of one span's matches, with
            host_parse.invert      the inversion (or merge) to positions
            host_parse.extend      the extension of capped lengths, scores
            host_parse.dict_probe  the merge of the device's
                                   static-dictionary candidates
            host_parse.walk        the greedy walk
            host_parse.commands    max_device: the commands of the
                                   device's parse (its only child)
          store.context          the context mode and literal context map
          store.literals         the literal extraction
          store.split            the literal block split; where it
                                 reaches the Lloyd loop, with
            split.device           the copy in, the Lloyd loop on the
                                   device and the two copies back
            split.hysteresis       the run hysteresis (host)
            split.merge            the header-cost merge (host)
          store.metablock        the native store and the bit append (no
                                 runtime: the Python planner and store)
          store.raw              a span stored uncompressed where the
                                 native store refused it or grew it
      dict.positions   the positions the dictionary probe took
      dict.won         those whose dictionary candidate beat the
                       window's match
      parse.positions  max_device: the positions the device's parse
                       committed over
      parse.copied     those its copies cover
      match.positions  q9 (the exact9 matcher, two folds merged): the
                       positions its merge took
      match.short_won  those whose merged match came from the short
                       fold (its score strictly beat the exact8 fold's),
                       counted on the device"""
    with trace.recording("compress_gpu", stats,
                         DICT_COUNTERS + PARSE_COUNTERS + MATCH_COUNTERS,
                         sums={"device_wait_s": "pipe.wait"}):
        dev = resolve_device(device)
        raw = np.frombuffer(bytes(data), dtype=np.uint8)
        params = EncoderParams(quality=quality, lgwin=lgwin,
                               mode=mode).sanitize(len(raw))
        n = len(raw)
        w = BitWriter()
        bs.write_stream_header(w, params.lgwin, params.large_window)
        if n == 0:
            bs.write_empty_last_meta_block(w)
            return w.getvalue()

        if span is None:
            span = 1 << params.lgblock
        # the halo always covers the window, so (a) every in-window match
        # is visible to the device and (b) row-local positions p >= halo
        # have min(p, window) == min(abs_pos, window) -- dictionary
        # pseudo-distances computed row-locally are exact
        halo = -(-(params.window_size + 16) // 4096) * 4096
        knobs = _device_knobs(params.quality)
        with trace.span("entry.rows"):
            rows, min_pos = _halo_rows(raw, span, halo)
        reals = [min(span, n - s0) for s0 in range(0, n, span)]

        # the route: what the device runs on a row, and what the host
        # makes of its results -- one span's (ins, cps, dst, adv)
        with trace.span("entry.call_setup"):
            if max_device:
                def device_step(j, row_d):
                    return _match_parse_dense(row_d, int(min_pos[j]),
                                              params.window_size, halo,
                                              k=knobs["k"],
                                              rounds=max(knobs["rounds"], 6),
                                              real=reals[j])

                def host_step(j, outs, dlen, region, cache):
                    # (visited, take, dist) of the span
                    with trace.span("host_parse.commands"):
                        seg = _commands_from_parse(*outs, reals[j])
                    if trace.on():
                        trace.count("parse.positions", reals[j])
                        trace.count("parse.copied", int(seg[1].sum()))
                    return seg
            else:
                # the host inversion is the runtime's: without it, invert
                # on the device
                device_invert = (_pick_device_invert(dev) if nb.available()
                                 else True)
                # traced q9: the device also counts the short fold's wins
                count_won = knobs["variant"] == "exact9" and trace.on()

                def device_step(j, row_d):
                    out = _match_dense(row_d, int(min_pos[j]),
                                       params.window_size, halo,
                                       device_invert=device_invert,
                                       short_won=(halo, halo + reals[j])
                                       if count_won else None, **knobs)
                    return (*out, dict_probe(row_d, halo, reals[j],
                                             int(min_pos[j]),
                                             params.window_size))

                def host_step(j, outs, dlen, region, cache):
                    # content-sorted space (pos_s, packed_s[, score_s] per
                    # fold) unless inverted on the device[, the count of
                    # the short fold's wins], then the dictionary
                    # candidates
                    if count_won:
                        trace.count("match.positions", reals[j])
                        trace.count("match.short_won", int(outs[-2][0]))
                        outs = (*outs[:-2], outs[-1])
                    return _host_parse(outs[:-1], outs[-1], rows[j], halo,
                                       reals[j], dlen, region, knobs,
                                       params.window_size, cache)[0]

            pipe = _Pipeline(rows, dev, device_step)
        for j in range(min(_MAX_INFLIGHT, len(rows))):
            pipe.dispatch(j)

        cache = list(C.INITIAL_DISTANCE_CACHE)
        for j, real in enumerate(reals):
            outs = pipe.wait(j)
            if j + _MAX_INFLIGHT < len(rows):
                pipe.dispatch(j + _MAX_INFLIGHT)
            # drop the zero-filled part of the halo: with dlen = halo -
            # min_pos (== min(s0, halo)) every row-local position maps to
            # its absolute stream position, so the walk's distance limits
            # and dictionary pseudo-distances are exact for every span
            dlen = halo - int(min_pos[j])
            region = rows[j][halo - dlen:halo + real]
            with trace.span("host_parse"):
                seg = host_step(j, outs, dlen, region, cache)
            cache = _store_span(w, region, dlen, real, seg, params, n,
                                j == len(rows) - 1, cache, dev)
        return w.getvalue()
