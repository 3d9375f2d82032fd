"""Batched decode with the device symbol-layer tier.

Counterpart of brotli_tpu/decode/batch_tpu.py.  decompress_batch_gpu
(streams) decodes N independent brotli streams.  For each stream the
host walks the stream and metablock headers and checks that the next
compressed metablock can run on the device; such metablocks become
lanes, and their symbol layer (command / literal / distance decode
with extra bits and the distance ring) runs in one launch of the
per-lane step kernel (ops/decode_gpu.py, csrc/decode_step.cu).  The
host then replays each lane's (insert, copy, distance) commands over
its literals (native LZ execution, or the Python loop where the runtime
is not in use; every header walk is then the Python one).  A
multi-metablock stream decodes over several device rounds: the device
returns each lane's end bit and final distance ring, and the host walk
resumes there.  Both walks, the first and the resumed, run natively
(csrc/lane_walk.cpp) and fall back to the Python walk, whose plan,
None or error then stands, where the native one refuses.

A metablock can run on the device when it has one block type in all
three categories and one literal tree and one distance tree (the
context maps are then all zero).  Static-dictionary references are
resolved on this path.  Any other stream, and any lane the device
flags, is decoded by the native host decoder; the results are the same
either way.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native_bridge as nb
from ..core import constants as C
from ..core.bitio import BitReader, NeedsMoreInput
from ..core.dictionary import get_dictionary
from ..core.prefix import read_prefix_code
from ..device import resolve_device
from ..ops.decode_gpu import PH_DONE, batch_decode_device
from ..utils import trace
from .decoder import (BrotliDecodeError, _read_context_map, _read_count_code,
                      _read_window_bits, decompress)

# what a malformed or truncated stream raises in the host walk; such a
# stream goes to the host decoder, which raises the matching error
_WALK_ERRORS = (BrotliDecodeError, NeedsMoreInput, ValueError, IndexError)


class _Lane:
    __slots__ = ("stream_idx", "data", "bit0", "mlen", "window",
                 "npostfix", "ndirect", "lit_len", "cmd_len",
                 "dist_len", "cache", "out_prefix_len", "is_final")

    def __init__(self, **kw):
        self.is_final = True
        for k, v in kw.items():
            setattr(self, k, v)


def _native_walk(data: bytes, bit_pos: int, window_size: int, cache,
                 out_len: int):
    """native_bridge.lane_walk's (segs, pending), as _walk_from would
    return them, or None where it refuses.  bit_pos -1 walks from the
    stream header (the window then comes from its WBITS)."""
    r = nb.lane_walk(data, bit_pos, out_len)
    if r is None:
        return None
    pre, lane = r
    segs = [("bytes", data[off:off + ln]) for off, ln in pre]
    if lane is None:
        return segs, False
    (bit0, mlen, wbits, npostfix, ndirect, out_prefix_len, is_final,
     lit_len, cmd_len, dist_len) = lane
    segs.append(("lane", _Lane(
        stream_idx=-1, data=data, bit0=bit0, mlen=mlen,
        window=(1 << wbits) - 16 if bit_pos < 0 else window_size,
        npostfix=npostfix, ndirect=ndirect, lit_len=lit_len,
        cmd_len=cmd_len, dist_len=dist_len, cache=list(cache),
        out_prefix_len=out_prefix_len, is_final=is_final)))
    return segs, not is_final


def _try_parse_stream(data: bytes):
    """Walk one stream on the host.  Returns (plan, pending): plan is a
    list of segments, each ("bytes", b) literal output or ("lane",
    _Lane) a device metablock, or None if the stream cannot use the
    device tier; pending is True when the walk stopped at a non-final
    compressed metablock (the caller resumes it with
    _resume_parse_stream once the device reports that lane's end bit
    and final distance ring).  The native walk takes the stream where
    it can; the Python walk takes what it refuses, and every stream
    where the runtime is not in use."""
    if nb.available():
        with trace.span("walk.native"):
            r = _native_walk(data, -1, 0, C.INITIAL_DISTANCE_CACHE, 0)
        if r is not None:
            trace.count("walks_native")
            return r
    trace.count("walks_python")
    with trace.span("walk.python"):
        reader = BitReader(data)
        wbits = _read_window_bits(reader)
        return _walk_from(data, reader, (1 << wbits) - 16,
                          list(C.INITIAL_DISTANCE_CACHE), 0)


def _resume_parse_stream(data: bytes, bit_pos: int, cache,
                         window_size: int, out_len: int):
    """Continue a paused walk right after a device-decoded metablock
    (bit_pos: the device's end bit; cache: its final distance ring),
    natively where the native walk takes it, else in Python."""
    if nb.available():
        with trace.span("walk.native"):
            r = _native_walk(data, bit_pos, window_size, cache, out_len)
        if r is not None:
            trace.count("walks_native")
            return r
    trace.count("walks_resumed")
    with trace.span("walk.resume"):
        reader = BitReader(data)
        reader.bit_pos = bit_pos
        return _walk_from(data, reader, window_size, list(cache), out_len)


def _walk_from(data, reader, window_size, cache, out_len):
    """The walk.  Returns (segs, pending); segs None = the stream cannot
    use the device tier (multi-type or context-modeled metablock).  A
    stream that ends in the walk (ISLASTEMPTY, a final metadata block)
    gets the RFC 7932 section 9.2 final-padding check here; a stream
    that ends in a device lane gets it after the device pass."""
    segs = []
    while True:
        islast = reader.read(1)
        if islast and reader.read(1):
            if reader.align_to_byte() != 0:
                raise BrotliDecodeError(
                    "nonzero padding after last metablock")
            break
        mnibbles = reader.read(2)
        if mnibbles == 3:
            if reader.read(1):
                raise BrotliDecodeError("reserved bit set")
            mskip = reader.read(2)
            skip = 0
            if mskip:
                val = reader.read(8 * mskip)
                if mskip > 1 and (val >> (8 * (mskip - 1))) == 0:
                    raise BrotliDecodeError("non-minimal MSKIPLEN")
                skip = val + 1
            if reader.align_to_byte():
                raise BrotliDecodeError("nonzero metadata padding")
            reader.read_bytes(skip)
            if islast:
                break
            continue
        mlen = reader.read(16 + 4 * mnibbles) + 1
        if mnibbles > 0 and (mlen - 1) >> (16 + 4 * (mnibbles - 1)) == 0:
            raise BrotliDecodeError("non-minimal MNIBBLES")
        if not islast and reader.read(1):  # ISUNCOMPRESSED
            if reader.align_to_byte() != 0:
                raise BrotliDecodeError("nonzero uncompressed padding")
            segs.append(("bytes", reader.read_bytes(mlen)))
            out_len += mlen
            continue

        # compressed metablock header: one block type per category
        # (NBLTYPESL, NBLTYPESI, NBLTYPESD), or the host decodes it
        for _ in "LID":
            if _read_count_code(reader) != 1:
                return None, False
        npostfix = reader.read(2)
        ndirect = reader.read(4) << npostfix
        reader.read(2)  # the literal context mode of the one block type
        ntrees_l = _read_count_code(reader)
        _read_context_map(reader, 64, ntrees_l)
        ntrees_d = _read_count_code(reader)
        _read_context_map(reader, 4, ntrees_d)
        if ntrees_l != 1 or ntrees_d != 1:
            return None, False
        dist_alpha = C.distance_alphabet_size(npostfix, ndirect, 24)
        lit_len = read_prefix_code(reader, 256)
        cmd_len = read_prefix_code(reader, 704)
        dist_len = read_prefix_code(reader, dist_alpha)
        lane = _Lane(stream_idx=-1, data=data, bit0=reader.bit_pos,
                     mlen=mlen, window=window_size, npostfix=npostfix,
                     ndirect=ndirect, lit_len=lit_len, cmd_len=cmd_len,
                     dist_len=dist_len, cache=list(cache),
                     out_prefix_len=out_len, is_final=bool(islast))
        segs.append(("lane", lane))
        out_len += mlen
        # the walk cannot pass a metablock it has not decoded: a
        # non-final device metablock pauses it until the device pass
        if not islast:
            return segs, True
        break
    return segs, False


def _reconstruct(lane: _Lane, prefix: bytes, lits: np.ndarray, nlit: int,
                 cmds: np.ndarray, ncmd: int) -> bytes:
    """The metablock's bytes from the device's literals and commands,
    over the stream's output so far (distances reach back across
    metablocks; the device validated them against that length): the
    runtime's LZ execution, or the Python loop where it is not in
    use."""
    if nb.available():
        body = nb.lz_execute(prefix, lits[:nlit], cmds[:ncmd], ncmd,
                             lane.window, lane.mlen)
        if body is None:
            raise BrotliDecodeError("device metablock length mismatch")
        return body
    out = bytearray(prefix)
    p0 = len(prefix)
    li = 0
    for ins, cpy, dist in cmds[:ncmd].tolist():
        if ins:
            out += bytes(lits[li:li + ins])
            li += ins
        if cpy:
            n = len(out)
            max_dist = min(n, lane.window)
            if dist > max_dist:
                # a static-dictionary reference: the device checked the
                # word id and advanced by the transform's output length
                out += get_dictionary().resolve(cpy, dist - max_dist - 1)
            elif dist <= 0:
                raise BrotliDecodeError("bad distance from device")
            elif dist >= cpy:
                out += out[n - dist:n - dist + cpy]
            else:
                for _ in range(cpy):
                    out.append(out[-dist])
    if len(out) - p0 != lane.mlen:
        raise BrotliDecodeError("device metablock length mismatch")
    return bytes(out[p0:])


def lane_arrays(lanes, dev: torch.device):
    """batch_decode_device's arguments for `lanes` on `dev`: the lane
    arrays are built in numpy and copied to `dev` once.  Returns (args,
    max_steps, s_lit, s_cmd); the buffers and the step cap come from
    the batch's longest metablock."""
    n = len(lanes)
    lmax = max(len(ln.data) for ln in lanes)
    mlen_max = max(ln.mlen for ln in lanes)
    da_max = max(len(ln.dist_len) for ln in lanes)
    data = np.zeros((n, lmax), np.uint8)
    lens = np.zeros((n, 256 + 704 + da_max), np.int32)
    for j, ln in enumerate(lanes):
        data[j, :len(ln.data)] = np.frombuffer(ln.data, np.uint8)
        lens[j, :256] = ln.lit_len
        lens[j, 256:960] = ln.cmd_len
        lens[j, 960:960 + len(ln.dist_len)] = ln.dist_len
    # rows: bit0, mlen, window, npostfix, ndirect, out_prefix, cache0[4]
    meta = np.array([[ln.bit0, ln.mlen, ln.window, ln.npostfix, ln.ndirect,
                      ln.out_prefix_len, *ln.cache] for ln in lanes],
                    np.int32).T.copy()
    data_d = torch.from_numpy(data).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    meta_d = torch.from_numpy(meta).to(dev)
    args = (data_d, meta_d[0], meta_d[1], meta_d[2], meta_d[3], meta_d[4],
            meta_d[6:10].T, lens_d[:, :256], lens_d[:, 256:960],
            lens_d[:, 960:], meta_d[5])
    return args, 3 * mlen_max + 64, mlen_max, mlen_max // 2 + 8


def _run_device(lanes, dev: torch.device):
    """One device pass over `lanes`.  The count vectors come back first,
    then only the realized prefix of the wide buffers.  Returns numpy (lits, nlit, cmds, ncmd, end_bit, status,
    cache_out)."""
    with trace.span("round.lanes"):
        args, max_steps, s_lit, s_cmd = lane_arrays(lanes, dev)
    with trace.span("round.kernel"):
        lits, nlit, cmds, ncmd, end_bit, status, cache_out = \
            batch_decode_device(*args, max_steps, s_lit, s_cmd)
        small = torch.stack([nlit, ncmd, end_bit, status]).cpu().numpy()
    nlit, ncmd, end_bit, status = small
    with trace.span("round.copy_back"):
        cache_out = cache_out.cpu().numpy()
        wl = max(int(nlit.max(initial=0)), 1)
        wc = max(int(ncmd.max(initial=0)), 1)
        return (lits[:, :wl].cpu().numpy(), nlit,
                cmds[:, :wc].cpu().numpy(), ncmd, end_bit, status,
                cache_out)


DECODE_COUNTERS = ("walks_native", "walks_python", "walks_resumed")


def decompress_batch_gpu(streams, max_rounds: int = 8, device=None,
                         stats: dict | None = None):
    """Decode N streams: metablocks that can run on the device decode
    their symbol layer there, everything else on the host.  Runs on
    CUDA unless device="cpu" is passed (then the plain step loop runs
    on the host).  Returns (outputs, n_device): n_device counts the
    streams decoded entirely through device lanes.

    stats: pass a dict to trace the call (utils/trace.py; with None
    nothing is recorded).  It receives
      wall_s  the whole call, in seconds
      spans   (name, parent index, t0_ns, t1_ns) on the perf_counter_ns
              clock, parent -1 for the root:
          decompress_batch_gpu  the call
          walk.native           the native header walk, first or resumed
                                (also one that refuses the stream)
          walk.python           a first walk in Python
          walk.resume           a paused walk resumed in Python
          round.lanes           the lane arrays built and copied in
          round.kernel          the launch through the counts' read-back
          round.copy_back       the realized outputs to the host
          reconstruct           a lane's LZ execution
          assemble              the joins of a stream's output so far
          fallback              the host decoder on a refused stream
      and the counters
          walks_native          walks, first or resumed, the native walk
                                took
          walks_python          first walks in Python
          walks_resumed         walks resumed in Python"""
    with trace.recording("decompress_batch_gpu", stats, DECODE_COUNTERS):
        dev = resolve_device(device)
        n_streams = len(streams)
        segs_acc = [[] for _ in range(n_streams)]
        failed = [False] * n_streams
        done = [False] * n_streams
        used_device = [False] * n_streams

        def add_plan(i, plan, pend, out):
            got_lane = False
            for kind, seg in plan:
                if kind == "lane":
                    seg.stream_idx = i
                    out.append(seg)
                    got_lane = True
                else:
                    segs_acc[i].append(seg)
            if not pend and not got_lane:
                done[i] = True  # nothing left for the device

        lanes = []
        for i, s in enumerate(streams):
            try:
                plan, pend = _try_parse_stream(bytes(s))
            except _WALK_ERRORS:
                plan, pend = None, False
            if plan is None:
                failed[i] = True
                continue
            add_plan(i, plan, pend, lanes)

        rounds = 0
        while lanes and rounds < max_rounds:
            rounds += 1
            lits, nlit, cmds, ncmd, end_bit, status, cache_out = _run_device(
                lanes, dev)
            next_lanes = []
            for j, ln in enumerate(lanes):
                i = ln.stream_idx
                if failed[i]:
                    continue
                if int(status[j]) != PH_DONE:
                    failed[i] = True  # malformed construct: host fallback
                    continue
                end = int(end_bit[j])
                # RFC 7932 section 9.2: the final padding bits must be zero
                # (the host decoder then raises the matching error)
                if ln.is_final and (end & 7) and \
                        (ln.data[end >> 3] >> (end & 7)) != 0:
                    failed[i] = True
                    continue
                with trace.span("assemble"):
                    prefix = b"".join(segs_acc[i])
                try:
                    with trace.span("reconstruct"):
                        body = _reconstruct(ln, prefix, lits[j], int(nlit[j]),
                                            cmds[j], int(ncmd[j]))
                except BrotliDecodeError:
                    failed[i] = True
                    continue
                segs_acc[i].append(body)
                used_device[i] = True
                if ln.is_final:
                    done[i] = True
                    continue
                try:
                    plan, pend = _resume_parse_stream(
                        ln.data, end, cache_out[j].tolist(), ln.window,
                        ln.out_prefix_len + ln.mlen)
                except _WALK_ERRORS:
                    plan, pend = None, False
                if plan is None:
                    failed[i] = True
                    continue
                add_plan(i, plan, pend, next_lanes)
            lanes = next_lanes
        for ln in lanes:  # round budget spent: these streams fall back
            failed[ln.stream_idx] = True

        outputs = []
        n_device = 0
        for i, s in enumerate(streams):
            if done[i] and not failed[i]:
                with trace.span("assemble"):
                    outputs.append(b"".join(segs_acc[i]))
                # walk-only streams complete here too, but only streams that
                # went through a device lane count
                n_device += int(used_device[i])
            else:
                with trace.span("fallback"):
                    outputs.append(decompress(bytes(s)))
        return outputs, n_device
