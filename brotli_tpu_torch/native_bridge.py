"""The port's own build of and bindings to the repo's C++ runtime.

native/*.cpp is compiled with g++ -O3 into brotli_tpu_torch/_build/
(one object per source, compiled in parallel, then linked).  The
library's file name carries a hash of the sources, the flags and the
host CPU, so a checkout rebuilds whenever any of them changes and a
library built for another CPU is never loaded.  The port's own
csrc/lane_walk.cpp (the batch decoder's header walk) is built the same
way into a library of its own, at its first call.

The no-runtime mode: with BROTLI_TPU_TORCH_NO_NATIVE set (to anything
but "" or "0"), or where the build fails, available() is false and
every caller takes its pure-Python or numpy route (the JAX package's
BROTLI_TPU_NO_NATIVE routes): the match finder, the greedy walk, the
command resolve, the optimal parser's DP and collectors, the metablock
planner and store, the bit packer, the host decoders and the batch
decoder's header walk and LZ execution.  The switch is read at every
available() and get_lib() call; with it set nothing under native/ is
compiled or loaded, and the batch decoder, which calls lane_walk only
where available(), builds no lane walk either.  get_lib() then raises
(it never returns None), so a binding called without the available()
guard fails loudly.  The CUDA
kernels (csrc/*.cu, buildcache.py) are not part of the runtime: they
build and launch in both modes.

Bound here: greedy_parse, extend_caps, encode_metablock,
invert_perm32 / invert_merge32 (the host inversion of the device's
sorted-space fold outputs), resolve_distance_codes and pack_bits (the
q0/q1 trivial metablock store), decode (the host decoder), and the
batch decoder's header walk (lane_walk: csrc/lane_walk.cpp, which
stops at the first compressed metablock, final or not, and resumes at
a device lane's end bit) and LZ execution of device-decoded commands
(lz_execute).  For the host encoder
(encode/encoder.py): store_metablock (the optimized metablock
planner), the whole-stream q0/q1 and q2/q3 pipelines
(compress_fragment_pipeline, compress_session_pipeline), the
per-metablock fragment parse (fragment_parse_seg), the match finder
(find_best_matches), ParseSession (the incremental search + parse,
which the streaming compressor extends chunk by chunk), and the C
API's work pool (work_pool_compress), max_compressed_size and the
preallocated encoder (prealloc_scratch_size, compress_prealloc).  For
the FFI: decode_into, the decode into a caller's buffer.  For the
optimal parser (encode/zopfli.py): the candidate collectors
(collect_matches, collect_dict_sorted over the sorted dictionary index,
collect_dict over the hashed one), the literal cost estimate (est_lit),
the candidate preparation (zopfli_cands*), the DPs (zopfli_dp_cands
over candidates, zopfli_dp_cache and zopfli_dp over edge lists) and
their backtrack (zopfli_backtrack).

Every binding returns arrays of its own (no buffer is pooled across
calls), so results may be kept and handed across threads.  The
exceptions are explicit: rows a caller passes in (`out=`, `state_bufs=`)
are written in place, and sorted_dict_index_native returns read-only
views of the runtime's own constant tables.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import warnings
from functools import lru_cache

import numpy as np

from .buildcache import build_once

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_SOURCES = ["hotloops.cpp", "broccoli.cpp", "decoder.cpp",
            "storeblock.cpp", "capi.cpp", "workpool.cpp", "zopfli_hq.cpp"]
_HEADERS = ["dict_embed.inc"]
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None
_dict_refs = []

I32P = ctypes.POINTER(ctypes.c_int32)
I64P = ctypes.POINTER(ctypes.c_int64)
U8P = ctypes.POINTER(ctypes.c_uint8)
U64P = ctypes.POINTER(ctypes.c_uint64)
F32P = ctypes.POINTER(ctypes.c_float)
F64P = ctypes.POINTER(ctypes.c_double)
I64 = ctypes.c_int64


def _ptr(a, t=I64P):
    return a.ctypes.data_as(t)


def _cpu_id() -> str:
    """The host CPU's model and feature flags (-march=native output
    depends on them)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f
                     if ln.startswith(("model name", "flags"))]
        return "".join(lines[:2])
    except OSError:
        return platform.processor()


def _build_key(paths) -> str:
    h = hashlib.sha256()
    for path in paths:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(_CXXFLAGS).encode())
    h.update(_cpu_id().encode())
    return h.hexdigest()[:16]


def _compile(out: str, work: str) -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("brotli_tpu_torch: g++ not found; the native "
                           "runtime cannot be built")
    objs = [os.path.join(work, s + ".o") for s in _SOURCES]
    procs = [subprocess.Popen(
        [cxx, *_CXXFLAGS, "-c", os.path.join(_NATIVE_DIR, s), "-o", o],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for s, o in zip(_SOURCES, objs)]
    logs, errors = [], []
    for s, p in zip(_SOURCES, procs):
        log = p.communicate()[0].decode("utf-8", "replace")
        logs.append(log)
        if p.returncode != 0:
            errors.append(f"{s}:\n{log[:2000]}")
    if errors:
        raise RuntimeError("brotli_tpu_torch: native build failed\n"
                           + "\n".join(errors))
    subprocess.run([cxx, "-shared", "-pthread", *objs, "-o", out],
                   check=True, capture_output=True)
    return "".join(logs)


def build() -> str:
    """Compile native/*.cpp (one g++ per source, side by side) into the
    build directory unless the library for the current key is there;
    returns the library's path."""
    key = _build_key(os.path.join(_NATIVE_DIR, name)
                     for name in _SOURCES + _HEADERS)
    return build_once(f"libbrotli_native_{key}.so", _compile)[0]


NO_NATIVE_ENV = "BROTLI_TPU_TORCH_NO_NATIVE"


def switched_off() -> bool:
    """Whether BROTLI_TPU_TORCH_NO_NATIVE asks for the no-runtime
    mode."""
    return os.environ.get(NO_NATIVE_ENV, "") not in ("", "0")


_build_error = None


def get_lib():
    """The loaded runtime (built on first use).  Raises RuntimeError in
    the no-runtime mode (the switch set, or a build that failed)."""
    global _lib
    if switched_off():
        raise RuntimeError(f"brotli_tpu_torch: the native runtime is "
                           f"switched off ({NO_NATIVE_ENV})")
    if _build_error is not None:
        raise RuntimeError("brotli_tpu_torch: the native runtime did not "
                           "build") from _build_error
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _bind(lib)
            _install_decoder_dictionary(lib)
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the runtime is in use: false where the switch is set
    (nothing is built) or the build fails.  A failure is warned about
    once and remembered, so every caller takes its pure-Python route
    without building again."""
    global _build_error
    if switched_off():
        return False
    if _lib is not None:
        return True
    if _build_error is not None:
        return False
    try:
        get_lib()
        return True
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _build_error = e
        warnings.warn(f"brotli_tpu_torch: native runtime unavailable, the "
                      f"pure-Python routes run instead: {e!r}",
                      RuntimeWarning)
        return False


def _bind(lib) -> None:
    lib.greedy_parse_native.restype = I64
    lib.greedy_parse_native.argtypes = [
        U8P, I64, I64, I64P, I64P, I64P, U8P, I64P, I64P, I64,
        I64P, I64, I64, I64P, I64, I64, I64, I64, I64, I64, I64,
        I64P, I64P, I64P, I64P, I64P, I64]
    lib.extend_caps_native.restype = None
    lib.extend_caps_native.argtypes = [U8P, I64, I64, I64P, I64P, I64P,
                                       I64, I64P]
    lib.encode_metablock_native.restype = I64
    lib.encode_metablock_native.argtypes = [
        U8P, I64, I64, I64, I64, I64P, I64P, I64P, I64P, I64P, I64,
        I64, I64, I64, I64, I64, I64, I64P, U8P, U8P, I64,
        ctypes.c_void_p, I64, U64P, I64, I64]
    lib.invert_perm32_native.restype = None
    lib.invert_perm32_native.argtypes = [I32P, I32P, I64, I32P]
    lib.invert_merge32_native.restype = None
    lib.invert_merge32_native.argtypes = [I32P] * 6 + [I64, I32P, I32P]
    lib.resolve_commands_native.restype = None
    lib.resolve_commands_native.argtypes = [
        I64P, I64P, I64P, I64P, I64, I64, I64, I64P, I64, I64,
        I64P, I64P, I64P, U8P, I64P]
    lib.pack_bits_native.restype = I64
    lib.pack_bits_native.argtypes = [U64P, I64P, I64, U64P]
    lib.decode_native.restype = I64
    lib.decode_native.argtypes = [U8P, I64, U8P, I64, U8P, I64, I64,
                                  I32P, I64]
    lib.lz_execute_native.restype = I64
    lib.lz_execute_native.argtypes = [U8P, I64, I32P, I64, I64, I64, I64,
                                      U8P]
    lib.decoder_set_dictionary.restype = None
    lib.decoder_set_dictionary.argtypes = [U8P, I64P, I64P, U8P, I64P,
                                           U8P, I64P, I64P, U8P, U8P]
    # the static-dictionary index of the match finders (null when the
    # dictionary is off): table, hash bits, slots, word bytes, word
    # lengths, word ids, size bits, omitted-transform ids
    dict_idx = [I64P, I64, I64, U8P, I64P, I64P, I64P, I64P]
    lib.store_metablock_native.restype = I64
    lib.store_metablock_native.argtypes = [
        U8P, I64, I64, I64, I64, I64P, I64P, I64P, I64P, I64P, I64P, I64P,
        I64, I64, I64, I64, I64, I64, I64P, U8P, U8P, I64,
        ctypes.c_void_p, I64, U64P, I64, I64]
    lib.compress_fragment_pipeline_native.restype = I64
    lib.compress_fragment_pipeline_native.argtypes = [
        U8P, I64, I64, I64, I64, I64, I64, I64, I64P, U64P, I64]
    lib.fragment_parse_seg_native.restype = I64
    lib.fragment_parse_seg_native.argtypes = [
        U8P, I64, I64, I64, I64, I64, I64, I64P, I64P, I64P, I64P, I64]
    lib.find_matches_native.restype = None
    lib.find_matches_native.argtypes = [
        U8P, I64, I64, I64, I64, I64, I64, I64, I64, I64, I64,
        *dict_idx, I64P, I64P, I64P, U8P, I64P, I64P, I64P, I64, I64P]
    lib.compress_session_pipeline_native.restype = I64
    lib.compress_session_pipeline_native.argtypes = [
        U8P, I64, I64, I64, I64, I64, I64, I64, I64, I64, I64, I64,
        *dict_idx, I64, I64, I64P, U64P, I64]
    lib.parse_session_begin.restype = ctypes.c_void_p
    lib.parse_session_begin.argtypes = [
        U8P, I64, I64, I64, I64, I64, I64, I64, I64, I64, I64,
        *dict_idx, I64, I64P]
    lib.parse_session_next.restype = I64
    lib.parse_session_next.argtypes = [ctypes.c_void_p, I64, I64P, I64P,
                                       I64P, I64P, I64]
    lib.parse_session_prime.restype = None
    lib.parse_session_prime.argtypes = [ctypes.c_void_p, I64]
    lib.parse_session_end.restype = None
    lib.parse_session_end.argtypes = [ctypes.c_void_p]
    lib.parse_session_extend.restype = None
    lib.parse_session_extend.argtypes = [ctypes.c_void_p, U8P, I64]
    size_t = ctypes.c_size_t
    lib.BrotliEncoderMaxCompressedSize.restype = size_t
    lib.BrotliEncoderMaxCompressedSize.argtypes = [size_t]
    lib.BrotliEncoderCreateWorkPool.restype = ctypes.c_void_p
    lib.BrotliEncoderCreateWorkPool.argtypes = [size_t] + [
        ctypes.c_void_p] * 3
    lib.BrotliEncoderCompressWorkPool.restype = ctypes.c_int
    lib.BrotliEncoderCompressWorkPool.argtypes = [
        ctypes.c_void_p, size_t, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), size_t, ctypes.c_char_p,
        ctypes.POINTER(size_t), ctypes.c_char_p, size_t]
    lib.BrotliEncoderPreallocScratchSizeQ.restype = size_t
    lib.BrotliEncoderPreallocScratchSizeQ.argtypes = [size_t, ctypes.c_int]
    lib.BrotliEncoderCompressPrealloc.restype = ctypes.c_int
    lib.BrotliEncoderCompressPrealloc.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, size_t, ctypes.c_char_p,
        ctypes.POINTER(size_t), ctypes.c_char_p, size_t, ctypes.c_char_p]
    _bind_optimal_parser(lib)


def _bind_optimal_parser(lib) -> None:
    """The optimal parser's entry points (encode/zopfli.py)."""
    lib.collect_matches_native.restype = I64
    lib.collect_matches_native.argtypes = [
        U8P, I64, I64, I64, I64, I64, I64, I64, I64, I64, I64P, I64P, I64P,
        I64]
    lib.extend_caps_range_native.restype = None
    lib.extend_caps_range_native.argtypes = [U8P, I64, I64, I64P, I64P,
                                             I64P, I64, I64P, I64P]
    lib.est_lit_native.restype = None
    lib.est_lit_native.argtypes = [U8P, I64, U8P, I64, ctypes.c_int,
                                   ctypes.c_double, F64P]
    # one sparse candidate source: pos, len, dist, isdict, wire, count
    src = [I64P, I64P, I64P, U8P, I64P, I64]
    lib.zopfli_cands_native.restype = I64
    lib.zopfli_cands_native.argtypes = [
        I64P, I64P, I64P, U8P, I64P, I64, I64, I64, I64, I64, I64, I64,
        I64P, ctypes.c_void_p]
    dense = [I64P, I64P, U8P, I64P, I64, *src, *src, I64, I64, I64, I64,
             I64, I64, I64P, ctypes.c_void_p]
    lib.zopfli_cands_dense_native.restype = I64
    lib.zopfli_cands_dense_native.argtypes = dense
    lib.zopfli_cands_dense_range_native.restype = I64
    lib.zopfli_cands_dense_range_native.argtypes = dense + [I64, I64]
    dp = [I64, I64, I64, I64, F64P, F64P, F64P, F64P, I64, I64P,
          ctypes.c_void_p, I64P, I64P, I64P, I64P, U8P, I64, I64, I64,
          I64P, F32P, I32P, I32P, I32P, I32P, I32P]
    lib.zopfli_dp_cands_native.restype = None
    lib.zopfli_dp_cands_native.argtypes = dp
    lib.zopfli_dp_cands_range_native.restype = None
    lib.zopfli_dp_cands_range_native.argtypes = dp + [I64, I64, I64P]
    lib.zopfli_dp_cache_native.restype = None
    lib.zopfli_dp_cache_native.argtypes = [
        I64, F64P, F64P, F64P, I64P, I64P, I64P, I64P, I64P, F64P, F64P,
        I64P, I64P, I64P, I64P, U8P, I64, I64, I64, I64P, F64P, I64P, I64P,
        I64P, I64P, I64P]
    lib.zopfli_dp_native.restype = None
    lib.zopfli_dp_native.argtypes = [
        I64, F64P, F64P, I64P, I64P, I64P, I64P, I64P, F64P, I64P, I64P,
        I64P, F64P, I64P, I64P, I64P, I64P]
    lib.zopfli_backtrack_native.restype = I64
    lib.zopfli_backtrack_native.argtypes = [I64, F64P, F64P] + [I64P] * 8
    lib.collect_dict_native.restype = I64
    lib.collect_dict_native.argtypes = [
        U8P, I64, I64, I64, U8P, I64, I64P, I64P, I64P, I32P, I64, I64,
        I64P, I64P, I64P, I64P, I64]
    lib.BrotliTpuEnsureHqDict.restype = None
    lib.BrotliTpuEnsureHqDict.argtypes = []
    lib.zopfli_hq_sorted_index.restype = I64
    lib.zopfli_hq_sorted_index.argtypes = [
        ctypes.POINTER(U8P), ctypes.POINTER(I64P), ctypes.POINTER(I64P),
        ctypes.POINTER(I64P)]
    lib.dict_sorted_init_native.restype = None
    lib.dict_sorted_init_native.argtypes = [U8P, I64P, I64, I32P, U8P,
                                            U64P, I32P]
    lib.collect_dict_sorted_native.restype = I64
    lib.collect_dict_sorted_native.argtypes = [
        U8P, I64, I64, I64, U8P, I64P, I64P, I64P, I32P, I64, U8P, U64P,
        I32P, I64P, I64P, I64P, I64P, I64, I64P]


def _install_decoder_dictionary(lib) -> None:
    """Hand the RFC dictionary, transforms and context LUTs (this
    package's data/ copies) to the native decoder; the arrays stay
    referenced for the life of the process."""
    from .core import constants as C
    from .core.dictionary import get_dictionary
    d = get_dictionary()
    data = np.frombuffer(d.data, dtype=np.uint8)
    n_len = 25
    offsets = np.zeros(n_len, dtype=np.int64)
    size_bits = np.zeros(n_len, dtype=np.int64)
    for length in range(4, n_len):
        offsets[length] = int(d.offsets_by_length[length])
        size_bits[length] = int(d.size_bits_by_length[length])
    tp = np.zeros((121, 16), dtype=np.uint8)
    ts = np.zeros((121, 16), dtype=np.uint8)
    tpl = np.zeros(121, dtype=np.int64)
    tsl = np.zeros(121, dtype=np.int64)
    tt = np.zeros(121, dtype=np.int64)
    for i in range(121):
        p = d.t_prefix[i]
        sfx = d.t_suffix[i]
        tp[i, :len(p)] = np.frombuffer(p, np.uint8)
        ts[i, :len(sfx)] = np.frombuffer(sfx, np.uint8)
        tpl[i] = len(p)
        tsl[i] = len(sfx)
        tt[i] = d.t_type[i]
    lut0 = np.ascontiguousarray(C.CONTEXT_LUT0, dtype=np.uint8)
    lut1 = np.ascontiguousarray(C.CONTEXT_LUT1, dtype=np.uint8)
    refs = (data, offsets, size_bits, tp, tpl, ts, tsl, tt, lut0, lut1)
    _dict_refs.append(refs)
    lib.decoder_set_dictionary(
        _ptr(data, U8P), _ptr(offsets), _ptr(size_bits),
        _ptr(tp, U8P), _ptr(tpl), _ptr(ts, U8P), _ptr(tsl), _ptr(tt),
        _ptr(lut0, U8P), _ptr(lut1, U8P))


_table_mem = None   # the native decoder's 32 MiB table, once per process
_decode_out = None  # pooled output buffer: a fresh multi-MB array pays a
#                     page fault per 4 KiB of decoded output
POOL_MAX = 1 << 26  # larger outputs get a buffer of their own


def _decode_native(src, out, cd, large_window) -> int:
    """One native decode of u8 `src` into u8 `out` after the custom
    dictionary `cd`, on the table kept across calls; returns its code:
    the decoded length, -1 (truncated), -2 (corrupt) or -3 (`out` too
    small)."""
    global _table_mem
    lib = get_lib()
    if _table_mem is None:
        _table_mem = np.zeros(1 << 23, dtype=np.int32)
    return lib.decode_native(
        _ptr(src, U8P), len(src), _ptr(out, U8P), len(out),
        _ptr(cd, U8P) if len(cd) else U8P(), len(cd),
        int(large_window), _ptr(_table_mem, I32P), len(_table_mem))


def decode(data: bytes, custom_dictionary: bytes = b"",
           large_window: bool = False) -> bytes:
    """Native one-shot decode; `custom_dictionary` is the output before
    the stream's first byte, `large_window` admits the large-window
    header.  Raises ValueError(code) with code -1 (truncated) or -2
    (corrupt).  The table and an output buffer of up to POOL_MAX bytes
    are kept across calls."""
    global _decode_out
    src = np.frombuffer(bytes(data), dtype=np.uint8)
    cd = np.frombuffer(bytes(custom_dictionary), dtype=np.uint8)
    cap = 4 * len(src) + (1 << 16)
    while True:
        if cap <= POOL_MAX:
            if _decode_out is None or len(_decode_out) < cap:
                _decode_out = np.empty(max(cap, 1 << 22), dtype=np.uint8)
            out = _decode_out
            cap = len(out)
        else:
            out = np.empty(cap, dtype=np.uint8)
        r = _decode_native(src, out, cd, large_window)
        if r == -3:  # output buffer too small
            if cap >= 1 << 40:
                raise MemoryError("decoded output exceeds 1 TiB")
            cap *= 8
            continue
        if r < 0:
            raise ValueError(int(r))
        return out[:r].tobytes()


def decode_into(data: bytes, out, custom_dictionary: bytes = b"",
                large_window: bool = False) -> int:
    """Preallocated decode (the reference's
    BrotliDecoderDecompressPrealloc): decode into the caller's writable
    buffer, nothing allocated beyond decode()'s table.  Returns the
    decoded length; raises TypeError for a read-only buffer, BufferError
    where the buffer is too small, ValueError(code) on corrupt or
    truncated input."""
    out_arr = np.frombuffer(out, dtype=np.uint8)
    if not out_arr.flags.writeable:
        raise TypeError("decode_into: the output buffer is read-only")
    r = _decode_native(np.frombuffer(bytes(data), dtype=np.uint8), out_arr,
                       np.frombuffer(bytes(custom_dictionary),
                                     dtype=np.uint8), large_window)
    if r == -3:
        raise BufferError("output buffer too small")
    if r < 0:
        raise ValueError(int(r))
    return int(r)


def lz_execute(prefix: bytes, lits, cmds, ncmd: int, window: int,
               mlen: int):
    """Apply device-decoded literals and (insert, copy, distance)
    commands over the output so far (`prefix`; distances reach into it,
    and past the window they name static-dictionary words).  Returns
    the metablock's `mlen` bytes, or None when the commands do not
    produce exactly `mlen` bytes."""
    lib = get_lib()
    lits = np.ascontiguousarray(lits, np.uint8)
    cmds = np.ascontiguousarray(cmds, np.int32)
    if cmds.ndim != 2 or cmds.shape[1] != 3 or len(cmds) < ncmd:
        raise ValueError("lz_execute: cmds must be int32 [>= ncmd, 3]")
    buf = np.empty(len(prefix) + int(mlen) + 64, np.uint8)
    if len(prefix):
        buf[:len(prefix)] = np.frombuffer(prefix, np.uint8)
    r = lib.lz_execute_native(
        _ptr(lits, U8P), len(lits), _ptr(cmds, I32P), int(ncmd),
        len(prefix), int(window), int(mlen), _ptr(buf, U8P))
    if r != mlen:
        return None
    return buf[len(prefix):len(prefix) + int(mlen)].tobytes()


_LANE_WALK_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "csrc", "lane_walk.cpp")
LANE_WALK_MAX_PRE = 64
_walk_fn = None
_walk_error = None


def _compile_lane_walk(out: str, work: str) -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("brotli_tpu_torch: g++ not found; the native "
                           "lane walk cannot be built")
    r = subprocess.run([cxx, *_CXXFLAGS, "-shared", _LANE_WALK_SRC, "-o",
                        out], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("brotli_tpu_torch: lane walk build failed\n"
                           + r.stdout[-2000:] + r.stderr[-2000:])
    return r.stdout + r.stderr


def _lane_walk_fn():
    """csrc/lane_walk.cpp's C function, built with g++ at first use
    (None where it did not build: warned about once)."""
    global _walk_fn, _walk_error
    if _walk_fn is None and _walk_error is None:
        with _lock:
            if _walk_fn is None and _walk_error is None:
                try:
                    path = build_once(
                        f"liblane_walk_{_build_key([_LANE_WALK_SRC])}.so",
                        _compile_lane_walk)[0]
                    fn = ctypes.CDLL(path).lane_walk
                except (OSError, RuntimeError,
                        subprocess.SubprocessError) as e:
                    _walk_error = e
                    warnings.warn(f"brotli_tpu_torch: the native lane walk "
                                  f"is unavailable, the Python walk runs "
                                  f"instead: {e!r}", RuntimeWarning)
                    return None
                fn.restype = I64
                fn.argtypes = [ctypes.c_char_p, I64, I64, I64,
                               ctypes.c_void_p, ctypes.c_void_p, I64,
                               ctypes.c_void_p]
                _walk_fn = fn
    return _walk_fn


class _WalkBuffers(threading.local):
    """lane_walk's outputs, one set a thread, reused by every call (520:
    the largest distance alphabet, NPOSTFIX 3 and NDIRECT 120)."""

    def __init__(self):
        self.meta = np.zeros(9, np.int64)
        self.pre = np.zeros(2 * LANE_WALK_MAX_PRE, np.int64)
        self.lens = np.zeros(256 + 704 + 520, np.int32)
        self.ptrs = (self.meta.ctypes.data, self.pre.ctypes.data,
                     self.lens.ctypes.data)


_walk_bufs = _WalkBuffers()


def lane_walk(data: bytes, bit_pos: int = -1, out_len: int = 0):
    """The batch decoder's header walk in csrc/lane_walk.cpp, from bit
    0 through the stream header (bit_pos -1) or from a resume's bit_pos
    with out_len output bytes so far: past uncompressed and metadata
    metablocks to the first compressed metablock, final or not.

    Returns None where the walk refuses (more than one block type or
    tree, truncation, corruption, more than LANE_WALK_MAX_PRE
    uncompressed metablocks; batch_gpu's Python walk then runs), else
    (pre, lane): pre the (byte offset, length) of each uncompressed
    metablock passed, and lane None where the stream ends in the walk,
    else (bit0, mlen, wbits, npostfix, ndirect, out_prefix_len,
    is_final, lit_len, cmd_len, dist_len) with wbits 0 on a resume and
    the code lengths int32 views of one new array."""
    fn = _lane_walk_fn()
    if fn is None:
        return None
    b = _walk_bufs
    r = fn(data, len(data), bit_pos, out_len, b.ptrs[0], b.ptrs[1],
           LANE_WALK_MAX_PRE, b.ptrs[2])
    if r == 0:
        return None
    meta = b.meta.tolist()
    flat = b.pre[:2 * meta[6]].tolist()
    pre = list(zip(flat[0::2], flat[1::2]))
    if r == 2:
        return pre, None
    lens = b.lens[:960 + meta[5]].copy()
    return pre, (meta[0], meta[1], meta[2], meta[3], meta[4], meta[7],
                 bool(meta[8]), lens[:256], lens[256:960], lens[960:])


# greedy walk tuning (the reference's values, as brotli_tpu passes
# them): copy length cap of the vectorized search, acceptance score,
# lazy-match margin, last-distance bonus, distance-cache probes, and
# the literal byte score
MATCH_CAP = 320
MIN_SCORE = 100
COST_DIFF_LAZY = 175
LAST_DIST_BONUS = 15
CACHE_PROBE_SPAN = 16
LBS = 135


def greedy_parse(data, best_len, best_dist, best_score, boundaries,
                 dict_len, pos0, initial_cache, best_isdict, window_size,
                 best_wire):
    """Native greedy walk over per-position best matches.  Segments are
    (insert[], wire_copy[], distance[], advance[]), one per boundary."""
    lib = get_lib()
    n = len(data) - dict_len
    bl = np.ascontiguousarray(best_len, dtype=np.int64)
    bd = np.ascontiguousarray(best_dist, dtype=np.int64)
    bs = np.ascontiguousarray(best_score, dtype=np.int64)
    isd = np.ascontiguousarray(best_isdict, dtype=np.uint8)
    bw = np.ascontiguousarray(best_wire, dtype=np.int64)
    if any(len(a) != n for a in (bl, bd, bs, isd, bw)):
        raise ValueError("greedy_parse: per-position arrays must cover "
                         "len(data) - dict_len positions")
    mpos = np.nonzero(bs > MIN_SCORE)[0].astype(np.int64)
    bnd = np.asarray(boundaries, dtype=np.int64)
    cache = np.asarray(initial_cache, dtype=np.int64)
    max_cmds = n + len(bnd) + 1
    out_i = np.empty(max_cmds, dtype=np.int64)
    out_c = np.empty(max_cmds, dtype=np.int64)
    out_d = np.empty(max_cmds, dtype=np.int64)
    out_a = np.empty(max_cmds, dtype=np.int64)
    seg_counts = np.zeros(len(bnd), dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n_out = lib.greedy_parse_native(
        _ptr(data, U8P), len(data), dict_len,
        _ptr(bl), _ptr(bd), _ptr(bs), _ptr(isd, U8P), _ptr(bw),
        _ptr(mpos), len(mpos), _ptr(bnd), len(bnd), pos0,
        _ptr(cache), window_size, MATCH_CAP, MIN_SCORE, COST_DIFF_LAZY,
        LAST_DIST_BONUS, CACHE_PROBE_SPAN, LBS,
        _ptr(out_i), _ptr(out_c), _ptr(out_d), _ptr(out_a),
        _ptr(seg_counts), max_cmds)
    segments = []
    off = 0
    for cnt in seg_counts.tolist():
        segments.append((out_i[off:off + cnt], out_c[off:off + cnt],
                         out_d[off:off + cnt], out_a[off:off + cnt]))
        off += cnt
    if off != n_out:
        raise RuntimeError("greedy_parse_native: segment counts disagree")
    return segments


def extend_caps(data, dict_len, pos, dist, lens):
    """Exact-length extension of length-capped matches."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    pos = np.ascontiguousarray(pos, np.int64)
    dist = np.ascontiguousarray(dist, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out = np.empty(len(pos), np.int64)
    lib.extend_caps_native(_ptr(data, U8P), len(data), dict_len,
                           _ptr(pos), _ptr(dist), _ptr(lens), len(pos),
                           _ptr(out))
    return out


def worst_case_bits(mlen: int) -> int:
    """A buffer under which the metablock stores refuse no block of
    mlen bytes: 16 bits a byte (their refusal test charges 16 bits for
    each literal of the next insert) and 2^17 bits of headers.  The
    tests store refused blocks natively on it and hold the pure-Python
    planner's bytes (bitstream.store_meta_block_auto's route) to them."""
    return 16 * int(mlen) + (1 << 17)


def encode_metablock(data, start, mlen, is_last, ins, wire, dist, adv,
                     cache, window_size, npostfix, ndirect, dist_alpha,
                     quality, context_mode, num_lit_ctx, lit_static_map,
                     lut0, lut1, ext_lit_split=None, cap_bits=None,
                     enable_splits=True):
    """Fused per-metablock resolve + plan + serialize.  Returns (words,
    nbits, new_cache), or None on overflow (the caller stores the span
    uncompressed; the cache is unchanged then).  enable_splits=False
    plans no block splits (the host encoder below quality 4).

    ext_lit_split: optional (types_per_literal int32[], num_types), a
    literal block split planned on the device (ops/split.py).
    cap_bits: the output buffer's bits; None = 9 * mlen + 2^17, the
    JAX package's bound.  The store refuses a block when its running
    size plus 16 bits for each literal of the next insert passes it."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    ins = np.ascontiguousarray(ins, np.int64)
    wire = np.ascontiguousarray(wire, np.int64)
    dist = np.ascontiguousarray(dist, np.int64)
    adv = np.ascontiguousarray(adv, np.int64)
    cache_io = np.asarray(cache, dtype=np.int64).copy()
    if cap_bits is None:
        cap_bits = 9 * int(mlen) + (1 << 17)
    words = np.zeros(cap_bits // 64 + 2, np.uint64)
    smap = np.ascontiguousarray(lit_static_map, np.int64)
    lut0 = np.ascontiguousarray(lut0, np.uint8)
    lut1 = np.ascontiguousarray(lut1, np.uint8)
    ext_types = None
    ext_n = 0
    if ext_lit_split is not None:
        ext_types = np.ascontiguousarray(ext_lit_split[0], np.int32)
        ext_n = int(ext_lit_split[1])
    r = lib.encode_metablock_native(
        _ptr(data, U8P), start, mlen, int(is_last), len(ins),
        _ptr(ins), _ptr(wire), _ptr(dist), _ptr(adv),
        _ptr(cache_io), window_size, npostfix, ndirect, dist_alpha,
        quality, context_mode, num_lit_ctx,
        _ptr(smap), _ptr(lut0, U8P), _ptr(lut1, U8P), int(enable_splits),
        None if ext_types is None else ext_types.ctypes.data, ext_n,
        _ptr(words, U64P), cap_bits, 0)
    if r < 0:
        return None
    return words, int(r), cache_io.tolist()


def resolve_distance_codes(insert_len, copy_len, distance, npostfix,
                           ndirect, initial_cache, pos_offset,
                           window_size, wire_copy=None):
    """Native distance-code + command-symbol resolution; returns
    (code, extra, extra_bits, use_last, cmd_sym, final_cache).
    copy_len is the ADVANCE (position-stepping) length; wire_copy the
    wire copy length (defaults to copy_len)."""
    lib = get_lib()
    il = np.ascontiguousarray(insert_len, dtype=np.int64)
    cl = np.ascontiguousarray(copy_len, dtype=np.int64)
    dl = np.ascontiguousarray(distance, dtype=np.int64)
    wc = cl if wire_copy is None else np.ascontiguousarray(
        wire_copy, dtype=np.int64)
    n = len(il)
    if any(len(a) != n for a in (cl, dl, wc)):
        raise ValueError("resolve_distance_codes: arrays differ in length")
    cache = np.asarray(initial_cache, dtype=np.int64).copy()
    out_code = np.empty(n, dtype=np.int64)
    out_extra = np.empty(n, dtype=np.int64)
    out_bits = np.empty(n, dtype=np.int64)
    out_ul = np.empty(n, dtype=np.uint8)
    out_sym = np.empty(n, dtype=np.int64)
    lib.resolve_commands_native(
        _ptr(il), _ptr(cl), _ptr(dl), _ptr(wc), n, npostfix, ndirect,
        _ptr(cache), pos_offset, window_size, _ptr(out_code),
        _ptr(out_extra), _ptr(out_bits), _ptr(out_ul, U8P), _ptr(out_sym))
    return out_code, out_extra, out_bits, out_ul.astype(bool), \
        out_sym, cache.tolist()


def pack_bits(bits, nbits):
    """Pack (bits[i], nbits[i]) items LSB-first into uint64 words;
    returns (words, total_bits).  Each item fits 32 bits."""
    lib = get_lib()
    bits = np.ascontiguousarray(bits, dtype=np.uint64)
    nbits = np.ascontiguousarray(nbits, dtype=np.int64)
    if len(bits) != len(nbits):
        raise ValueError("pack_bits: arrays differ in length")
    total = int(nbits.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint64), 0
    words = np.zeros(total // 64 + 2, dtype=np.uint64)
    lib.pack_bits_native(_ptr(bits, U64P), _ptr(nbits), len(bits),
                         _ptr(words, U64P))
    return words, total


def invert_perm32(pos_s, val_s):
    """out[pos_s[j]] = val_s[j]; pos_s is a permutation of [0, n)."""
    lib = get_lib()
    pos_s = np.ascontiguousarray(pos_s, np.int32)
    val_s = np.ascontiguousarray(val_s, np.int32)
    n = len(pos_s)
    out = np.empty(n, np.int32)
    lib.invert_perm32_native(_ptr(pos_s, I32P), _ptr(val_s, I32P), n,
                             _ptr(out, I32P))
    return out


def invert_merge32(pos_a, val_a, sc_a, pos_b, val_b, sc_b):
    """Double inversion of the two q9 folds: apply permutation A, then
    B where B's score strictly wins."""
    lib = get_lib()
    args = [np.ascontiguousarray(a, np.int32)
            for a in (pos_a, val_a, sc_a, pos_b, val_b, sc_b)]
    n = len(args[0])
    if any(len(a) != n for a in args):
        raise ValueError("invert_merge32: arrays differ in length")
    out_val = np.empty(n, np.int32)
    out_sc = np.empty(n, np.int32)
    lib.invert_merge32_native(*[_ptr(a, I32P) for a in args], n,
                              _ptr(out_val, I32P), _ptr(out_sc, I32P))
    return out_val


def store_metablock(data, start, mlen, is_last, cmds, npostfix, ndirect,
                    dist_alpha, quality, context_mode, num_lit_ctx,
                    lit_static_map, lut0, lut1, enable_splits=True,
                    cap_bits=None):
    """Native metablock plan + serialize of resolved commands
    (CommandArrays).  Returns (words uint64[], nbits), or None where the
    store refuses the block for its buffer: cap_bits, None = 9 * mlen +
    2^17 (the JAX package's buffer).  The store refuses a block when its
    running size plus 16 bits for each literal of the next insert passes
    the buffer."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    arrs = [np.ascontiguousarray(a, np.int64) for a in (
        cmds.insert_len, cmds.copy_len, cmds.dist_code, cmds.dist_extra,
        cmds.dist_extra_bits, cmds.cmd_sym, cmds.copy_advance)]
    n = len(arrs[0])
    if any(len(a) != n for a in arrs):
        raise ValueError("store_metablock: command arrays differ in length")
    if cap_bits is None:
        cap_bits = 9 * int(mlen) + (1 << 17)
    words = np.zeros(cap_bits // 64 + 2, np.uint64)
    smap = np.ascontiguousarray(lit_static_map, np.int64)
    lut0 = np.ascontiguousarray(lut0, np.uint8)
    lut1 = np.ascontiguousarray(lut1, np.uint8)
    r = lib.store_metablock_native(
        _ptr(data, U8P), start, mlen, int(is_last), n,
        *[_ptr(a) for a in arrs], npostfix, ndirect, dist_alpha, quality,
        context_mode, num_lit_ctx, _ptr(smap), _ptr(lut0, U8P),
        _ptr(lut1, U8P), int(enable_splits), None, 0,
        _ptr(words, U64P), cap_bits, 0)
    if r < 0:
        return None
    return words, int(r)


def compress_fragment_pipeline(data, window_size, span, quality,
                               suppress_last, initial_cache, bit_phase=0,
                               table_bits=17):
    """Whole-stream q0/q1 encode: the fragment parse on a worker thread,
    the trivial store and the bit assembly on the caller's, one native
    call.  `bit_phase` is the writer's bit within its last byte, so
    ISUNCOMPRESSED alignment lands on true stream bytes.  Returns
    (words, nbits, cache) with nbits counted from bit 0 of `words` (the
    first bit_phase bits are zero: append with append_packed_phased),
    or None where the output passes its buffer."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    n = len(data)
    table_bits = min(table_bits, max(9, n.bit_length()))
    cap_bits = 9 * n + (1 << 18)
    words = np.zeros(cap_bits // 64 + 2, np.uint64)
    cache_io = np.asarray(initial_cache, dtype=np.int64).copy()
    r = lib.compress_fragment_pipeline_native(
        _ptr(data, U8P), n, window_size, span, table_bits, quality,
        int(suppress_last), bit_phase & 7, _ptr(cache_io),
        _ptr(words, U64P), cap_bits)
    if r < 0:
        return None
    return words, int(r), cache_io.tolist()


def fragment_parse_seg(data, window_size, pos0, bound, reset,
                       table_bits=17):
    """One metablock of the fragment parse, with a direct-mapped table
    that persists across calls on one thread: every call for one stream
    must come from the same thread, reset=True on the first.  Returns
    (ins, cps, dst, adv), or None where the commands pass their
    buffer."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    n = len(data)
    table_bits = min(table_bits, max(9, n.bit_length()))
    cap = (bound - pos0) // 4 + 16
    outs = [np.empty(cap, np.int64) for _ in range(4)]
    m = lib.fragment_parse_seg_native(
        _ptr(data, U8P), n, pos0, window_size, table_bits, bound,
        1 if reset else 0, *[_ptr(a) for a in outs], cap)
    if m < 0:
        return None
    return tuple(a[:m] for a in outs)


def _dict_index_args(use_dictionary):
    """The match finders' static-dictionary arguments and the arrays
    under their pointers (the caller keeps those while native code may
    read them); nulls when the dictionary is off."""
    if not use_dictionary:
        null = I64P()
        return (null, 0, 0, U8P(), null, null, null, null), ()
    from .encode.static_dict import (DICT_HASH_BITS, dict_index,
                                     omit_last_transform_ids)
    word_bytes, word_len, word_idx, table, size_bits = dict_index()
    refs = (np.ascontiguousarray(table, dtype=np.int64),
            np.ascontiguousarray(word_bytes, dtype=np.uint8),
            np.ascontiguousarray(word_len, dtype=np.int64),
            np.ascontiguousarray(word_idx, dtype=np.int64),
            np.ascontiguousarray(size_bits, dtype=np.int64),
            np.ascontiguousarray(omit_last_transform_ids(), dtype=np.int64))
    args = (_ptr(refs[0]), DICT_HASH_BITS, refs[0].shape[1],
            _ptr(refs[1], U8P), _ptr(refs[2]), _ptr(refs[3]),
            _ptr(refs[4]), _ptr(refs[5]))
    return args, refs


def find_best_matches(data, window_size, k=8, bucket_bits=17, k8=4,
                      bucket_bits8=18, hash_len=4, literal_byte_score=540,
                      dict_len=0, use_dictionary=True, match_cap=320,
                      want_top2=False, miss_economy=False, out=None,
                      progress=None):
    """Best (len, dist, score, is_dict, wire_len) per position of
    data[dict_len:]: two hashed candidate tables (4- or 5-byte and
    8-byte hashes, k and k8 slots a bucket) and, with use_dictionary,
    the static dictionary.  want_top2 also returns the runner-up (len,
    dist) of another distance; miss_economy backs the scan depth off
    over matchless runs (the optimal parser's collection only).

    out: rows the caller owns (len, dist, score, isdict uint8, wire,
    top-2 len, top-2 dist; each n long, the top-2 rows None without
    want_top2), written from the native call; progress: an int64[1]
    the native search advances to the positions it has covered, so a
    caller on another thread may read the rows behind it."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    if out is not None:
        (best_len, best_dist, best_score, best_isdict, best_wire,
         b2l, b2d) = out
        _check_rows((best_len, best_dist, best_score, best_wire, b2l, b2d),
                    np.int64, n)
        _check_rows((best_isdict,), np.uint8, n)
        if want_top2 and (b2l is None or b2d is None):
            raise ValueError("find_best_matches: want_top2 needs the "
                             "top-2 rows")
    else:
        best_len = np.zeros(n, dtype=np.int64)
        best_dist = np.zeros(n, dtype=np.int64)
        best_score = np.zeros(n, dtype=np.int64)
        best_isdict = np.zeros(n, dtype=np.uint8)
        best_wire = np.zeros(n, dtype=np.int64)
        b2l = np.zeros(n, dtype=np.int64) if want_top2 else None
        b2d = np.zeros(n, dtype=np.int64) if want_top2 else None
    dict_args, dict_refs = _dict_index_args(use_dictionary)
    lib.find_matches_native(
        _ptr(data, U8P), n, dict_len, window_size, k, bucket_bits, k8,
        bucket_bits8, hash_len, literal_byte_score // 4, match_cap,
        *dict_args, _ptr(best_len), _ptr(best_dist), _ptr(best_score),
        _ptr(best_isdict, U8P), _ptr(best_wire),
        _ptr(b2l) if want_top2 else I64P(),
        _ptr(b2d) if want_top2 else I64P(), int(miss_economy),
        _ptr(progress) if progress is not None else I64P())
    del dict_refs
    sl = slice(dict_len, None)
    base = (best_len[sl], best_dist[sl], best_score[sl],
            best_isdict[sl].astype(bool), best_wire[sl])
    if want_top2:
        return base + (b2l[sl], b2d[sl])
    return base


def compress_session_pipeline(data, window_size, span, quality,
                              suppress_last, initial_cache, bit_phase=0,
                              use_dictionary=True, k=1, bucket_bits=16,
                              k8=0, bucket_bits8=15, hash_len=4, n_cache=1,
                              literal_byte_score=540):
    """Whole-stream q2/q3 encode: the basic-tier parse session on a
    worker thread, the trivial store and the bit assembly on the
    caller's, one native call.  Returns (words, nbits, cache) as
    compress_fragment_pipeline does, or None where the output passes
    its buffer."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    n = len(data)
    cap_bits = 9 * n + (1 << 18)
    words = np.zeros(cap_bits // 64 + 2, np.uint64)
    cache_io = np.asarray(initial_cache, dtype=np.int64).copy()
    dict_args, dict_refs = _dict_index_args(use_dictionary)
    r = lib.compress_session_pipeline_native(
        _ptr(data, U8P), n, window_size, span, quality, k, bucket_bits,
        k8, bucket_bits8, hash_len, n_cache, literal_byte_score // 4,
        *dict_args, int(suppress_last), bit_phase & 7, _ptr(cache_io),
        _ptr(words, U64P), cap_bits)
    del dict_refs
    if r < 0:
        return None
    return words, int(r), cache_io.tolist()


class ParseSession:
    """The native search + parse, delivered one metablock at a time:
    its hash tables, distance cache and walk position persist across
    next() calls, so the segments equal one whole-input parse.  next()
    and prime() must be called serially in boundary order (from any
    one thread at a time; the calls release the GIL).  The input and
    dictionary arrays under the native pointers are held until close(),
    which ends the native session once."""

    def __init__(self, data, window_size, dict_len=0, pos0=0,
                 initial_cache=(4, 11, 15, 16), k=8, bucket_bits=17,
                 k8=4, bucket_bits8=18, hash_len=4, n_cache=4,
                 literal_byte_score=540, use_dictionary=True):
        self._handle = None
        self._lib = get_lib()
        self._data = np.ascontiguousarray(data, dtype=np.uint8)
        dict_args, self._dict_refs = _dict_index_args(use_dictionary)
        self._cache = np.asarray(initial_cache, dtype=np.int64).copy()
        self._handle = self._lib.parse_session_begin(
            _ptr(self._data, U8P), len(self._data), dict_len, window_size,
            k, bucket_bits, k8, bucket_bits8, hash_len, n_cache,
            literal_byte_score // 4, *dict_args, pos0, _ptr(self._cache))
        if not self._handle:
            raise RuntimeError("parse_session_begin: no free session")

    def next(self, boundary_rel: int, max_cmds: int | None = None):
        """Parse up to boundary_rel (relative to the dictionary's end);
        returns one segment (insert[], wire[], dist[], advance[]).  By
        default room for boundary_rel // 2 + 2 commands."""
        if self._handle is None:
            raise RuntimeError("ParseSession: closed")
        if max_cmds is None:
            max_cmds = boundary_rel // 2 + 2
        outs = [np.empty(max_cmds, dtype=np.int64) for _ in range(4)]
        cnt = self._lib.parse_session_next(
            self._handle, boundary_rel, *[_ptr(a) for a in outs], max_cmds)
        return tuple(a[:cnt] for a in outs)

    def prime(self, boundary_rel: int):
        """Advance the session to boundary_rel by hash-table inserts
        alone (no search, no commands): the dual-session parse skips
        the half-metablocks the other session parses."""
        if self._handle is None:
            raise RuntimeError("ParseSession: closed")
        self._lib.parse_session_prime(self._handle, boundary_rel)

    def extend(self, data):
        """Append input to a live session (the streaming compressor's
        PROCESS): `data` holds the session's earlier bytes unchanged as
        its prefix.  The session keeps `data` (a view of the caller's
        buffer, not a copy) so that the native pointer stays valid."""
        if self._handle is None:
            raise RuntimeError("ParseSession: closed")
        self._data = np.ascontiguousarray(data, dtype=np.uint8)
        self._lib.parse_session_extend(
            self._handle, _ptr(self._data, U8P), len(self._data))

    def close(self):
        if self._handle is not None:
            self._lib.parse_session_end(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


# --- the optimal parser (encode/zopfli.py) --------------------------------


def _check_rows(rows, dtype, n):
    """Arrays a caller owns and native code reads or writes: each (but
    None) must be C-contiguous and of `dtype`, a row at least n long, a
    [rows, n] matrix exactly n wide."""
    for a in rows:
        if a is None:
            continue
        short = a.shape[1] != n if a.ndim == 2 else len(a) < n
        if a.dtype != dtype or short or not a.flags.c_contiguous:
            raise ValueError(f"caller-owned array: need contiguous {dtype} "
                             f"of {n}, got {a.dtype} {a.shape}")

#: a native Zopfli candidate (hotloops.cpp's ZCand, 16 bytes)
ZCAND_DTYPE = np.dtype([("len", "<i4"), ("wire", "<i4"), ("dist", "<i4"),
                        ("sym", "<i2"), ("nbits", "u1"), ("flags", "u1")])


def collect_matches(data, window_size, dict_len=0, k=48, bucket_bits=17,
                    k8=24, bucket_bits8=18, min_len=4, max_per_pos=16):
    """Every useful match a position (the optimal parser's window
    candidates): (pos, len, dist), pos relative to data[dict_len]."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    cap = max(1, n - dict_len) * max_per_pos // 2 + 1024
    outs = [np.empty(cap, np.int64) for _ in range(3)]
    m = lib.collect_matches_native(
        _ptr(data, U8P), n, dict_len, window_size, k, bucket_bits, k8,
        bucket_bits8, min_len, max_per_pos, *[_ptr(a) for a in outs], cap)
    return tuple(a[:m] for a in outs)


def extend_caps_range(data, dict_len, pos, dist, lens, state):
    """extend_caps over one chunk of hits: the walk's skip state (the
    end of the longest extension so far) is carried in state[0], so
    chunks in order give the one-call result."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    pos = np.ascontiguousarray(pos, np.int64)
    dist = np.ascontiguousarray(dist, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out = np.empty(len(pos), np.int64)
    lib.extend_caps_range_native(_ptr(data, U8P), len(data), dict_len,
                                 _ptr(pos), _ptr(dist), _ptr(lens),
                                 len(pos), _ptr(out), _ptr(state))
    return out


def est_lit(data, cls, half, utf8_ramp, bias):
    """Per-byte literal bit cost from a sliding window of +-half bytes
    (cls: the UTF-8 context class a byte, or None)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    cost = np.empty(len(data), np.float64)
    cls = None if cls is None else np.ascontiguousarray(cls, np.uint8)
    lib.est_lit_native(_ptr(data, U8P), len(data),
                       U8P() if cls is None else _ptr(cls, U8P), half,
                       1 if utf8_ramp else 0, bias, _ptr(cost, F64P))
    return cost


def _source(src):
    """One sparse candidate source as contiguous arrays."""
    s_pos, s_len, s_dist, s_isdict, s_wire = src
    return (np.ascontiguousarray(s_pos, np.int64),
            np.ascontiguousarray(s_len, np.int64),
            np.ascontiguousarray(s_dist, np.int64),
            np.ascontiguousarray(s_isdict, np.uint8),
            np.ascontiguousarray(s_wire, np.int64))


def _source_args(src, count):
    s_pos, s_len, s_dist, s_isdict, s_wire = src
    return (_ptr(s_pos), _ptr(s_len), _ptr(s_dist), _ptr(s_isdict, U8P),
            _ptr(s_wire), count)


def zopfli_cands(pos, lens, dists, isdict, wire, n, npostfix, ndirect,
                 k_win=12, k_dict=4, ladder_top=4):
    """Counting sort, dedupe and cap of concatenated candidate sources
    into per-position candidates: (cand_off[n + 1], ZCAND_DTYPE[])."""
    lib = get_lib()
    src = _source((pos, lens, dists, isdict, wire))
    m = len(src[0])
    cand_off = np.zeros(n + 1, np.int64)
    packed = np.empty(m, dtype=ZCAND_DTYPE)
    cnt = lib.zopfli_cands_native(
        *_source_args(src, m), n, npostfix, ndirect, k_win, k_dict,
        ladder_top, _ptr(cand_off), packed.ctypes.data)
    return cand_off, packed[:cnt]


def zopfli_cands_dense(d_len, d_dist, d_isdict, d_wire, extra, n,
                       npostfix, ndirect, k_win=12, k_dict=4,
                       ladder_top=4):
    """zopfli_cands over the dense [rows, n] candidate rows plus up to
    two sparse sources (`extra`: None, one (pos, len, dist, isdict,
    wire) tuple or a list of them, each sorted by position), merged
    natively.  None where a source is not sorted (zopfli_cands takes
    it then)."""
    lib = get_lib()
    d_len = np.ascontiguousarray(d_len, np.int64)
    d_dist = np.ascontiguousarray(d_dist, np.int64)
    d_isdict = np.ascontiguousarray(d_isdict, np.uint8)
    d_wire = np.ascontiguousarray(d_wire, np.int64)
    sources = [] if extra is None else (
        extra if isinstance(extra, list) else [extra])
    if len(sources) > 2:
        raise ValueError("zopfli_cands_dense: at most two sparse sources")
    srcs = [_source(x) for x in sources]
    m = int((d_len >= 2).sum()) + sum(len(x[0]) for x in srcs)
    e64, e8 = np.zeros(0, np.int64), np.zeros(0, np.uint8)
    while len(srcs) < 2:
        srcs.append((e64, e64, e64, e8, e64))
    cand_off = np.zeros(n + 1, np.int64)
    packed = np.empty(max(m, 1), dtype=ZCAND_DTYPE)
    cnt = lib.zopfli_cands_dense_native(
        _ptr(d_len), _ptr(d_dist), _ptr(d_isdict, U8P), _ptr(d_wire),
        d_len.shape[0], *_source_args(srcs[0], len(srcs[0][0])),
        *_source_args(srcs[1], len(srcs[1][0])), n, npostfix, ndirect,
        k_win, k_dict, ladder_top, _ptr(cand_off), packed.ctypes.data)
    if cnt < 0:
        return None
    return cand_off, packed[:cnt]


def zopfli_cands_dense_range(d_len, d_dist, d_isdict, d_wire, x_src, xm,
                             n, npostfix, ndirect, cand_off, packed,
                             p_start, p_end, k_win=12, k_dict=4,
                             ladder_top=4):
    """zopfli_cands_dense over positions [p_start, p_end), into the
    caller's cand_off and packed (contiguous, of the dtypes above, and
    held across chunks); x_src is one sparse source whose first xm
    entries are valid.  Returns the candidates so far (also written to
    cand_off[p_end])."""
    lib = get_lib()
    _check_rows((d_len, d_dist, d_wire), np.int64, n)
    _check_rows((d_isdict,), np.uint8, n)
    _check_rows(x_src[:3] + x_src[4:], np.int64, xm)
    _check_rows(x_src[3:4], np.uint8, xm)
    _check_rows((cand_off,), np.int64, n + 1)
    if packed.dtype != ZCAND_DTYPE:
        raise ValueError("zopfli_cands_dense_range: packed is not ZCands")
    e64, e8 = np.zeros(0, np.int64), np.zeros(0, np.uint8)
    return int(lib.zopfli_cands_dense_range_native(
        _ptr(d_len), _ptr(d_dist), _ptr(d_isdict, U8P), _ptr(d_wire),
        d_len.shape[0], *_source_args(x_src, xm),
        *_source_args((e64, e64, e64, e8, e64), 0), n, npostfix, ndirect,
        k_win, k_dict, ladder_top, _ptr(cand_off), packed.ctypes.data,
        p_start, p_end))


def zopfli_dp_cands(n, lcp, cost_cmd, cost_dist_short, cost_dist4, cands,
                    ins_code, ins_extra, cmd_sym, cmd_sym_last, data,
                    dict_len, window_size, initial_cache, n_starts=2,
                    cand_cap=0, max_zopfli_len=0, p_range=None,
                    qstate=None, state_bufs=None):
    """The distance-cache-aware shortest-path DP over prepared
    candidates (zopfli_cands*), with the sub-length ladder inline.
    Returns (cost f32, prev_start, prev_len, prev_wire, prev_dist), each
    n + 1 long.  Chunked: p_range = (p_start, p_end) runs those
    positions, with the start queue in the caller's qstate (int64[18])
    and the DP state in the caller's state_bufs (cost f32[n + 1], four
    int32[n + 1], node cache int32[4 (n + 1)]), both held across
    chunks."""
    lib = get_lib()
    cand_off, packed = cands
    lcp = np.ascontiguousarray(lcp, np.float64)
    cost_cmd = np.ascontiguousarray(cost_cmd, np.float64)
    cds = np.ascontiguousarray(cost_dist_short, np.float64)
    cd4 = np.ascontiguousarray(cost_dist4, np.float64)
    tabs = [np.ascontiguousarray(t, np.int64)
            for t in (ins_code, ins_extra, cmd_sym, cmd_sym_last)]
    data = np.ascontiguousarray(data, np.uint8)
    cache0 = np.ascontiguousarray(initial_cache, np.int64)
    if state_bufs is None:
        state_bufs = (np.empty(n + 1, np.float32),
                      *[np.empty(n + 1, np.int32) for _ in range(4)],
                      np.empty(4 * (n + 1), np.int32))
    cost, prev_start, prev_len, prev_wire, prev_dist, node_cache = \
        state_bufs
    _check_rows((cost,), np.float32, n + 1)
    _check_rows((prev_start, prev_len, prev_wire, prev_dist), np.int32,
                n + 1)
    _check_rows((node_cache,), np.int32, 4 * (n + 1))
    if p_range is not None:
        _check_rows((qstate,), np.int64, 18)
    args = [n, n_starts, cand_cap, max_zopfli_len, _ptr(lcp, F64P),
            _ptr(cost_cmd, F64P), _ptr(cds, F64P), _ptr(cd4, F64P),
            cd4.shape[1], _ptr(cand_off), packed.ctypes.data,
            *[_ptr(t) for t in tabs], _ptr(data, U8P), len(data), dict_len,
            window_size, _ptr(cache0), _ptr(cost, F32P),
            *[_ptr(a, I32P) for a in (prev_start, prev_len, prev_wire,
                                      prev_dist, node_cache)]]
    if p_range is None:
        lib.zopfli_dp_cands_native(*args)
    else:
        lib.zopfli_dp_cands_range_native(*args, p_range[0], p_range[1],
                                         _ptr(qstate))
    return cost, prev_start, prev_len, prev_wire, prev_dist


def zopfli_backtrack(n, lcp, cost, prev_start, prev_len, prev_wire,
                     prev_dist):
    """The cheapest close of a DP (a final insert run where it pays) and
    the walk back along its predecessors: (ins, wire, dist, advance)."""
    lib = get_lib()
    lcp = np.ascontiguousarray(lcp, np.float64)
    cost = np.ascontiguousarray(cost, np.float64)
    prev = [np.ascontiguousarray(a, np.int64)
            for a in (prev_start, prev_len, prev_wire, prev_dist)]
    outs = [np.empty(n + 2, np.int64) for _ in range(4)]
    cnt = lib.zopfli_backtrack_native(
        n, _ptr(lcp, F64P), _ptr(cost, F64P), *[_ptr(a) for a in prev],
        *[_ptr(a) for a in outs])
    return tuple(a[:cnt] for a in outs)


def zopfli_dp_cache(n, lcp, cost_cmd, cost_dist_short, edge_off, e_len,
                    e_wire, e_dist, e_ccode, e_base, e_dcost, ins_code_tab,
                    ins_extra_tab, cmd_sym_tab, cmd_sym_last_tab, data,
                    dict_len, window_size, initial_cache):
    """The cache-aware DP over a priced edge list (short-code edge costs
    and cache-continuation edges); returns (cost, prev_start, prev_len,
    prev_wire, prev_dist)."""
    lib = get_lib()
    f64 = [np.ascontiguousarray(a, np.float64)
           for a in (lcp, cost_cmd, cost_dist_short)]
    edges = [np.ascontiguousarray(a, np.int64)
             for a in (edge_off, e_len, e_wire, e_dist, e_ccode)]
    prices = [np.ascontiguousarray(a, np.float64) for a in (e_base,
                                                            e_dcost)]
    tabs = [np.ascontiguousarray(a, np.int64) for a in (
        ins_code_tab, ins_extra_tab, cmd_sym_tab, cmd_sym_last_tab)]
    data = np.ascontiguousarray(data, np.uint8)
    cache = np.ascontiguousarray(initial_cache, np.int64)
    cost = np.empty(n + 1, np.float64)
    prev = [np.empty(n + 1, np.int64) for _ in range(4)]
    node_cache = np.empty(4 * (n + 1), np.int64)
    lib.zopfli_dp_cache_native(
        n, *[_ptr(a, F64P) for a in f64], *[_ptr(a) for a in edges],
        *[_ptr(a, F64P) for a in prices], *[_ptr(a) for a in tabs],
        _ptr(data, U8P), len(data), dict_len, window_size, _ptr(cache),
        _ptr(cost, F64P), *[_ptr(a) for a in prev], _ptr(node_cache))
    return (cost, *prev)


def zopfli_dp(n, lcp, cost_cmd, edge_off, e_len, e_wire, e_dist, e_ccode,
              e_base, ins_code_tab, ins_extra_tab, cmd_sym_tab):
    """The DP over a priced edge list without the distance cache;
    returns (cost, prev_start, prev_len, prev_wire, prev_dist)."""
    lib = get_lib()
    lcp = np.ascontiguousarray(lcp, np.float64)
    cost_cmd = np.ascontiguousarray(cost_cmd, np.float64)
    edges = [np.ascontiguousarray(a, np.int64)
             for a in (edge_off, e_len, e_wire, e_dist, e_ccode)]
    e_base = np.ascontiguousarray(e_base, np.float64)
    tabs = [np.ascontiguousarray(a, np.int64)
            for a in (ins_code_tab, ins_extra_tab, cmd_sym_tab)]
    cost = np.empty(n + 1, np.float64)
    prev = [np.empty(n + 1, np.int64) for _ in range(4)]
    lib.zopfli_dp_native(
        n, _ptr(lcp, F64P), _ptr(cost_cmd, F64P), *[_ptr(a) for a in edges],
        _ptr(e_base, F64P), *[_ptr(a) for a in tabs], _ptr(cost, F64P),
        *[_ptr(a) for a in prev])
    return (cost, *prev)


def collect_dict(data, dict_len, window_size, entry_bytes, e_out, e_wire,
                 e_wid, table, hash_bits):
    """Transform-aware dictionary matches through the hashed expanded
    index (static_dict.expanded_dict_index): (pos, out_len,
    pseudo_dist, wire), pos relative to data[dict_len]."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    entry_bytes = np.ascontiguousarray(entry_bytes, np.uint8)
    index = [np.ascontiguousarray(a, np.int64) for a in (e_out, e_wire,
                                                         e_wid)]
    table = np.ascontiguousarray(table, np.int32)
    cap = max(16, (n - dict_len) * 6)
    outs = [np.empty(cap, np.int64) for _ in range(4)]
    m = lib.collect_dict_native(
        _ptr(data, U8P), n, dict_len, window_size, _ptr(entry_bytes, U8P),
        entry_bytes.shape[1], *[_ptr(a) for a in index], _ptr(table, I32P),
        hash_bits, table.shape[1], *[_ptr(a) for a in outs], cap)
    return tuple(a[:m] for a in outs)


def sorted_dict_index_native():
    """Every unique transformed dictionary output, sorted, as the
    runtime builds it: (sorted_bytes[m, 38], out_len, wire, wid),
    read-only views of tables the runtime holds for the life of the
    process and never rewrites."""
    lib = get_lib()
    lib.BrotliTpuEnsureHqDict()
    sb_p, len_p, wire_p, wid_p = U8P(), I64P(), I64P(), I64P()
    m = lib.zopfli_hq_sorted_index(
        ctypes.byref(sb_p), ctypes.byref(len_p), ctypes.byref(wire_p),
        ctypes.byref(wid_p))
    if m <= 0:
        raise RuntimeError("zopfli_hq_sorted_index: no index")
    views = (np.ctypeslib.as_array(sb_p, shape=(m, 38)),
             np.ctypeslib.as_array(len_p, shape=(m,)),
             np.ctypeslib.as_array(wire_p, shape=(m,)),
             np.ctypeslib.as_array(wid_p, shape=(m,)))
    for v in views:
        v.flags.writeable = False
    return views


@lru_cache(maxsize=1)
def _dict_sorted_state():
    """The sorted index's search tables (longest-prefix links, a bloom
    filter, 8-byte keys, 16-bit ranges), built once."""
    from .encode.static_dict import sorted_dict_index
    lib = get_lib()
    sb, s_len, _, _ = sorted_dict_index()
    m = len(s_len)
    lpf = np.empty(m, dtype=np.int32)
    bloom = np.empty(1 << 21, dtype=np.uint8)
    key8 = np.empty(m, dtype=np.uint64)
    range16 = np.empty(65537, dtype=np.int32)
    lib.dict_sorted_init_native(
        _ptr(sb, U8P), _ptr(s_len), m, _ptr(lpf, I32P), _ptr(bloom, U8P),
        _ptr(key8, U64P), _ptr(range16, I32P))
    return lpf, bloom, key8, range16


def collect_dict_sorted(data, dict_len, window_size, progress=None,
                        out=None):
    """Every transform-aware dictionary match, exactly, by a predecessor
    search over the sorted index: (pos, out_len, pseudo_dist, wire), pos
    relative to data[dict_len].  out: four int64 rows the caller owns
    (None is returned where they overflow); progress: int64[2], the
    region position covered and the entries emitted so far, advanced
    by the native search for a reader on another thread."""
    from .encode.static_dict import sorted_dict_index
    lib = get_lib()
    sb, s_len, s_wire, s_wid = sorted_dict_index()
    lpf, bloom, key8, range16 = _dict_sorted_state()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    cap = max(64, (n - dict_len) * 6)
    if out is not None:
        _check_rows(out, np.int64, len(out[0]))
    while True:
        rows = out if out is not None else [np.empty(cap, np.int64)
                                            for _ in range(4)]
        cnt = lib.collect_dict_sorted_native(
            _ptr(data, U8P), n, dict_len, window_size, _ptr(sb, U8P),
            _ptr(s_len), _ptr(s_wire), _ptr(s_wid), _ptr(lpf, I32P),
            len(s_len), _ptr(bloom, U8P), _ptr(key8, U64P),
            _ptr(range16, I32P), *[_ptr(a) for a in rows], len(rows[0]),
            _ptr(progress) if progress is not None else I64P())
        if cnt >= 0:
            return tuple(a[:cnt] for a in rows)
        if out is not None:
            return None
        cap *= 2


def max_compressed_size(input_size: int) -> int:
    """The C API's BrotliEncoderMaxCompressedSize."""
    return int(get_lib().BrotliEncoderMaxCompressedSize(input_size))


def prealloc_scratch_size(input_size: int, quality: int) -> int:
    """The scratch arena compress_prealloc needs (the C API's
    BrotliEncoderPreallocScratchSizeQ)."""
    return int(get_lib().BrotliEncoderPreallocScratchSizeQ(input_size,
                                                           quality))


def compress_prealloc(quality: int, lgwin: int, mode: int, data: bytes,
                      scratch) -> bytes | None:
    """One-shot encode whose big scratch is the caller's arena `scratch`
    (a ctypes char buffer; the C API's BrotliEncoderCompressPrealloc,
    q0-q9).  Returns the stream, or None where the C API refuses
    (quality above 9, an arena too small)."""
    data = bytes(data)
    enc = ctypes.create_string_buffer(len(data) + (1 << 16))
    esz = ctypes.c_size_t(len(enc))
    ok = get_lib().BrotliEncoderCompressPrealloc(
        quality, lgwin, mode, len(data), data, ctypes.byref(esz), enc,
        len(scratch), scratch)
    return enc.raw[:esz.value] if ok == 1 else None


_work_pool = None
_work_pool_lock = threading.Lock()
WORK_POOL_THREADS = 15


def work_pool_compress(data: bytes, num_parts: int, quality: int,
                       lgwin: int, mode: int) -> bytes:
    """CompressMulti through the C API's persistent work pool
    (BrotliEncoderCompressWorkPool: pthread shards, byte-aligned catable
    parts, concatenated).  The pool of WORK_POOL_THREADS threads is made
    at the first call and lives with the process."""
    global _work_pool
    lib = get_lib()
    with _work_pool_lock:
        if _work_pool is None:
            _work_pool = lib.BrotliEncoderCreateWorkPool(
                WORK_POOL_THREADS, None, None, None)
    # parameter ids of the C API: MODE = 0, QUALITY = 1, LGWIN = 2
    keys = (ctypes.c_uint32 * 3)(0, 1, 2)
    vals = (ctypes.c_uint32 * 3)(mode, quality, lgwin)
    cap = max_compressed_size(len(data)) + 64
    enc = ctypes.create_string_buffer(cap)
    esz = ctypes.c_size_t(cap)
    ok = lib.BrotliEncoderCompressWorkPool(
        _work_pool, 3, keys, vals, len(data), data, ctypes.byref(esz), enc,
        num_parts)
    if not ok:
        raise RuntimeError("BrotliEncoderCompressWorkPool failed")
    return enc.raw[:esz.value]
