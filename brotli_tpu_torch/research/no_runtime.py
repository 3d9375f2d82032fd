"""The no-runtime mode end to end: the device paths with pure-Python host
legs, and the host encoder's pure-Python routes.

    BROTLI_TPU_TORCH_NO_NATIVE=1 python -m brotli_tpu_torch.research.no_runtime \\
        --inputs INPUTS.pkl [--device cpu]

chip_smoke.py runs it in a child process with the switch set, after
writing its inputs with write_inputs: slices of the seeded corpus and
the first LANES streams of the serving batch (research/decode_batches.
py), whose odd streams come from the native encoder and so cannot be
made in this mode.  Each input takes a quarter of its bytes from the
head of each quarter of the corpus.  On the device (CUDA unless
--device cpu): compress_gpu at q5 and q9 on GPU_BYTES in GPU_SPAN spans
(the on-device inversion, which this mode always takes) and max_device
at q5;
compress_mesh at q5 over MESH_SHARDS shards of MESH_SHARD_BYTES;
compress_fast at q1 on FAST_BYTES (one short shard); decompress_batch_
gpu on the LANES streams.  On the host: compress at q1, q5 and q11 on
HOST_BYTES, the Compressor at q5 and compress_multi(backend="workpool")
(threads in this mode) on the same bytes.  Each call's MB/s (host
clock, one call), ratio, and the fold, match_rounds and decode_step
launches it made (the counts set to 0 just before it); every stream
decodes back through libbrotlidec (the port's decompress where the
machine has none).  Then each device path again at CHECK_BYTES on the
device and with device="cpu", which must give the same bytes (the
batch decoder on 8 compress_fast streams of 4 KiB; skipped under
--device cpu), and ops/bitpack.pack_bits_u32 on the device
against the numpy bitstream.pack_bits on the bit items of one
metablock (the largest item array of compress q5 on HOST_BYTES).  At
its end the runtime must never have been loaded (native_bridge._lib is
None).  The last line is {"no_runtime": {...}}: every call's numbers,
the launches and the wall.
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import json
import pickle
import sys
import time

GPU_BYTES, GPU_SPAN = 1 << 20, 1 << 19
MESH_SHARDS, MESH_SHARD_BYTES = 8, 128 << 10
FAST_BYTES = 512 << 10
HOST_BYTES = 256 << 10
LANES = 64
CHECK_BYTES = 128 << 10


def write_inputs(path: str, corpus: bytes, serve_streams, serve_inputs):
    """The child's inputs: the head of each quarter of the corpus (repo
    text, zipf words, records, then integers and random bytes), as long
    as a quarter of the largest input, and the first LANES streams of
    the serving batch."""
    size = max(GPU_BYTES, MESH_SHARDS * MESH_SHARD_BYTES, FAST_BYTES,
               HOST_BYTES, CHECK_BYTES) // 4
    q = len(corpus) // 4
    with open(path, "wb") as f:
        pickle.dump(dict(quarters=[corpus[k * q:k * q + size]
                                   for k in range(4)],
                         serve_streams=list(serve_streams[:LANES]),
                         serve_inputs=list(serve_inputs[:LANES])), f)


def _decoder():
    """libbrotlidec's one-shot decode, else the port's decompress."""
    name = ctypes.util.find_library("brotlidec")
    if name is None:
        from ..decode.decoder import decompress
        return "the port's decompress", lambda comp, size: decompress(comp)
    lib = ctypes.CDLL(name)
    lib.BrotliDecoderDecompress.restype = ctypes.c_int
    lib.BrotliDecoderDecompress.argtypes = [
        ctypes.c_size_t, ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_char_p]

    def decode(comp, size):
        out = ctypes.create_string_buffer(size + 1)
        osz = ctypes.c_size_t(size + 1)
        if lib.BrotliDecoderDecompress(len(comp), comp, ctypes.byref(osz),
                                       out) != 1:
            raise AssertionError("libbrotlidec rejected the stream")
        return out.raw[:osz.value]
    return "libbrotlidec", decode


class _Counts:
    """The three kernels' launch counters, set to 0 and read around one
    call.  A fold launch counts under its configuration's name; a
    match_rounds launch under its form ("match_rounds" or
    "match_rounds_shifted") and also under a finer key, which is not
    summed."""

    def __init__(self):
        from ..ops import decode_gpu, fold_cuda, match_rounds_cuda
        self.tables = {"fold": fold_cuda.LAUNCHES,
                       "match_rounds": match_rounds_cuda.LAUNCHES,
                       "decode_step": decode_gpu.LAUNCHES}
        self.keys = {"fold": None,
                     "match_rounds": ("match_rounds", "match_rounds_shifted"),
                     "decode_step": ("decode_step",)}
        self.total = {k: 0 for k in self.tables}

    def run(self, fn):
        for t in self.tables.values():
            t.clear()
        out = fn()
        got = {k: sum(v for key, v in t.items()
                      if self.keys[k] is None or key in self.keys[k])
               for k, t in self.tables.items()}
        for k, v in got.items():
            self.total[k] += v
        return out, got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .. import (Compressor, compress, compress_fast, compress_gpu,
                    compress_mesh, compress_multi, decompress_batch_gpu,
                    make_mesh)
    from .. import native_bridge as nb
    from ..device import resolve_device
    from ..encode import bitstream as B
    from ..ops.bitpack import pack_bits_u32, words_u32_to_bytes
    if not nb.switched_off():
        raise SystemExit(f"no_runtime: set {nb.NO_NATIVE_ENV}=1")
    dev = resolve_device(args.device)
    with open(args.inputs, "rb") as f:
        inputs = pickle.load(f)

    def take(n):
        """n bytes: n / 4 from each quarter of the corpus."""
        return b"".join(p[:n // 4] for p in inputs["quarters"])
    dname, decode = _decoder()
    counts = _Counts()
    calls = {}
    t_start = time.perf_counter()

    def call(what, fn, plain, kernel=None):
        t0 = time.perf_counter()
        out, launched = counts.run(fn)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        # a launch is counted on CUDA only (the CPU runs the plain
        # versions)
        if dev.type == "cuda" and kernel is not None \
                and launched[kernel] == 0:
            raise AssertionError(f"no_runtime {what}: no {kernel} launch")
        if isinstance(plain, bytes):
            if decode(out, len(plain)) != plain:
                raise AssertionError(f"no_runtime {what}: the {dname} "
                                     "round trip differs")
            ratio = len(plain) / len(out)
            size = len(plain)
        else:
            size = sum(len(p) for p in plain)
            ratio = None
        calls[what] = dict(bytes=size, s=dt, mb_s=size / dt / 1e6,
                           ratio=ratio, launches=launched)
        print(f"no-runtime {what}: {size / dt / 1e6:.4f} MB/s"
              + (f", ratio {ratio:.4f} ({len(out)} bytes)" if ratio else "")
              + f", {dt:.2f} s, launches {json.dumps(launched)}",
              flush=True)
        return out

    # the device paths, their host legs in Python
    gpu_in = take(GPU_BYTES)
    for q in (5, 9):
        call(f"compress_gpu q{q} ({GPU_BYTES >> 10} KiB)",
             lambda q=q: compress_gpu(gpu_in, quality=q, span=GPU_SPAN,
                                      device=dev), gpu_in, "fold")
    call(f"compress_gpu max_device q5 ({GPU_BYTES >> 10} KiB)",
         lambda: compress_gpu(gpu_in, quality=5, span=GPU_SPAN,
                              max_device=True, device=dev), gpu_in, "fold")
    mesh_in = take(MESH_SHARDS * MESH_SHARD_BYTES)
    call(f"compress_mesh q5 ({MESH_SHARDS} x {MESH_SHARD_BYTES >> 10} KiB)",
         lambda: compress_mesh(mesh_in, mesh=make_mesh(
             MESH_SHARDS, device=args.device), quality=5), mesh_in, "fold")
    fast_in = take(FAST_BYTES)
    call(f"compress_fast q1 ({FAST_BYTES >> 10} KiB)",
         lambda: compress_fast(fast_in, quality=1, device=dev), fast_in,
         "match_rounds")
    streams = inputs["serve_streams"]
    outs, n_device = call(
        f"decompress_batch_gpu ({len(streams)} lanes)",
        lambda: decompress_batch_gpu(streams, device=dev),
        inputs["serve_inputs"], "decode_step")
    if outs != inputs["serve_inputs"] or n_device != len(streams):
        raise AssertionError(f"no_runtime decompress_batch_gpu: outputs "
                             f"differ or n_device {n_device}")

    # the host encoder's routes
    host_in = take(HOST_BYTES)
    for q in (1, 5, 11):
        call(f"compress q{q} ({HOST_BYTES >> 10} KiB)",
             lambda q=q: compress(host_in, quality=q), host_in)

    def stream_q5():
        c = Compressor(quality=5, chunk_size=64 << 10)
        return b"".join([c.process(host_in), c.finish()])
    call(f"Compressor q5 ({HOST_BYTES >> 10} KiB)", stream_q5, host_in)
    call(f"compress_multi workpool q5 4 parts ({HOST_BYTES >> 10} KiB)",
         lambda: compress_multi(host_in, 4, quality=5, backend="workpool"),
         host_in)

    # card == CPU on small inputs
    checked = []
    if dev.type != "cpu":
        small = take(CHECK_BYTES)
        shard = CHECK_BYTES // MESH_SHARDS
        # 4 KiB streams: the plain step loop on the CPU takes about a
        # millisecond a step of the longest lane
        small_streams = [compress_fast(small[k:k + 4096], quality=1,
                                       device=dev)
                         for k in range(0, 8 * 4096, 4096)]
        pairs = {
            "compress_gpu q5": lambda d: compress_gpu(
                small, quality=5, span=CHECK_BYTES // 2, device=d),
            "compress_gpu q9": lambda d: compress_gpu(
                small, quality=9, span=CHECK_BYTES // 2, device=d),
            "compress_gpu max_device q5": lambda d: compress_gpu(
                small, quality=5, span=CHECK_BYTES // 2, max_device=True,
                device=d),
            "compress_mesh q5": lambda d: compress_mesh(
                small[:shard * MESH_SHARDS], mesh=make_mesh(
                    MESH_SHARDS, device=None if d == dev else "cpu"),
                quality=5),
            "compress_fast q1": lambda d: compress_fast(small, quality=1,
                                                        device=d),
            "decompress_batch_gpu": lambda d: decompress_batch_gpu(
                small_streams, device=d),
        }
        for what, fn in pairs.items():
            if fn(dev) != fn("cpu"):
                raise AssertionError(f"no_runtime {what}: the card and the "
                                     "CPU differ")
            checked.append(what)
        print(f"no-runtime card == cpu: {', '.join(checked)}", flush=True)

    # pack_bits_u32 on the device against the numpy pack_bits
    items = []
    pack = B.pack_bits

    def keep(bits, nbits):
        items.append((np.asarray(bits, np.uint64),
                      np.asarray(nbits, np.int64)))
        return pack(bits, nbits)
    B.pack_bits = keep
    try:
        compress(host_in, quality=5)
    finally:
        B.pack_bits = pack
    bits, nbits = max(items, key=lambda it: len(it[0]))
    t0 = time.perf_counter()
    want, want_bits = pack(bits, nbits)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    bits_d = torch.from_numpy(bits.astype(np.int64)).to(dev)
    nbits_d = torch.from_numpy(nbits).to(dev)
    total_words = int(nbits.sum()) // 32 + 2
    pack_bits_u32(bits_d, nbits_d, total_words)  # warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    words, total = pack_bits_u32(bits_d, nbits_d, total_words)
    got = words_u32_to_bytes(words, int(total))
    device_ms = (time.perf_counter() - t0) * 1e3
    if int(total) != want_bits or got.tobytes() != \
            want.view(np.uint8).tobytes()[:(want_bits + 7) // 8]:
        raise AssertionError("no_runtime pack_bits_u32: differs from the "
                             "numpy pack_bits")
    print(f"no-runtime pack_bits_u32 on {dev}: {len(bits)} items, "
          f"{want_bits} bits, equal to the numpy pack_bits; "
          f"{device_ms:.3f} ms with the copy back, numpy {numpy_ms:.3f} ms",
          flush=True)

    if nb._lib is not None:
        raise AssertionError("no_runtime: the native runtime was loaded")
    wall = time.perf_counter() - t_start
    print(f"no-runtime wall {wall:.1f} s; launches {json.dumps(counts.total)};"
          f" native_bridge._lib is None", flush=True)
    print(json.dumps({"no_runtime": dict(
        calls=calls, launches=counts.total, card_equals_cpu=checked,
        pack_bits_u32=dict(items=len(bits), bits=want_bits,
                           device_ms=device_ms, numpy_ms=numpy_ms),
        wall_s=wall)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
