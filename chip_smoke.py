#!/usr/bin/env python3
"""Smoke run of brotli_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # the full run, on one card

Builds the native runtime (native/*.cpp, g++) and the two CUDA kernels
(brotli_tpu_torch/csrc/fold.cu and match_rounds.cu, nvcc for sm_90a)
side by side, makes a 32 MiB corpus from a seed (text files of the
repo that the port leaves unchanged, zipf-distributed words,
structured records with noise, slowly varying integers, random bytes),
then:

  kernel phase  each fold configuration on 4,718,592 sorted rows of
                the corpus (the row of one 512 KiB span at lgwin 22),
                and match_rounds at R = 8 on the first 4 MiB shard
                (the h4 fold's sorted chunk values against their shift
                by 1, as compress_fast runs it): each kernel must equal
                its plain version on the card bit for bit; prints
                kernel ms (CUDA events, median of 15), the bound, and
                the plain version's ms
  path phase    on the whole corpus at lgwin 22: compress_gpu at q5,
                q7 and q9; compress_fast at q0 and q1; compress_gpu
                max_device at q5 and q9.  Each path's launch counters
                are set to 0 just before it and read just after, and
                each path must have launched each of its kernels; every
                output must decode back (libbrotlidec when present,
                else the port's native decoder)
  cpu check     each path on the card equals the same path with
                device="cpu" byte for byte on a 1 MiB prefix
  profile       where one q9 call on 8 MiB spends its time: host
                functions by own time (cProfile), device kernels by
                device time and the device's idle share (torch.profiler)

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero;
without CUDA, or without the package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
ROW = 4_194_304 + 524_288   # halo + span of one lgwin-22 dispatch
WINDOW = (1 << 22) - 16
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT_OPS_PER_S = 67e12       # non-tensor 32-bit peak (FP32 rate)
SRC = "brotli_tpu_torch/csrc/fold.cu"
REPLACES = "brotli_tpu/ops/fold_pallas.py:250"
MR_SRC = "brotli_tpu_torch/csrc/match_rounds.cu"
MR_REPLACES = "brotli_tpu/ops/pallas_match.py:62"
SHARD = 1 << 22             # compress_fast's shard
CORPUS_DOCS = ["PAPER.md", "PAPERS.md", "SNIPPETS.md", "SURVEY.md"]
CORPUS_MIB = 32
SEED = 20261016

# (label, n_keys, n_pay, k_fwd, k_back, fuse_short, the path that
# launches it: "gpu" = compress_gpu, "max_device" = compress_gpu
# max_device, None = no path of this script)
CONFIGS = [
    ("fold q2-6 exact", 1, 1, 32, 0, False, "gpu"),
    ("fold q7-8 exact8", 2, 0, 16, 8, False, "gpu"),
    ("fold q9 main", 2, 2, 16, 8, False, "gpu"),
    ("fold q9 short", 1, 1, 16, 0, False, "gpu"),
    ("fold exact9_fused", 2, 2, 16, 8, True, None),
    ("fold max_device q2-6", 1, 5, 32, 0, False, "max_device"),
    ("fold max_device q7-9", 1, 5, 16, 0, False, "max_device"),
]


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def build_all():
    """Native runtime and both CUDA kernels, compiled side by side."""
    from brotli_tpu_torch import native_bridge as nb
    from brotli_tpu_torch.ops import fold_cuda, match_rounds_cuda

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    builds = {"native": nb.build, "fold.cu": fold_cuda.LIB.build,
              "match_rounds.cu": match_rounds_cuda.LIB.build}
    with ThreadPoolExecutor(len(builds)) as ex:
        futs = {k: ex.submit(timed, fn) for k, fn in builds.items()}
        done = {k: f.result() for k, f in futs.items()}
    log("build: " + ", ".join(f"{k} {t:.1f} s" for k, (_, t) in
                              done.items()))
    for k in ("fold.cu", "match_rounds.cu"):
        for ln in done[k][0][1].splitlines():
            if "registers" in ln or ("spill" in ln and
                                     " 0 bytes spill stores" not in ln):
                log(f"  ptxas {k}:", ln.strip())


def make_corpus(mib: int, seed: int):
    """`mib` MiB from the seed: 1/4 repo text, 1/4 zipf words, 1/4
    records with noise, 1/8 slowly varying int32, 1/8 random bytes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    total = mib << 20
    q = total // 8
    # files the port leaves unchanged, so the corpus is the same at
    # every commit of the port
    files = sorted(glob.glob(os.path.join(ROOT, "native", "*.cpp"))
                   + [os.path.join(ROOT, f) for f in CORPUS_DOCS]
                   + glob.glob(os.path.join(ROOT, "brotli_tpu", "**",
                                            "*.py"), recursive=True))
    text = b"".join(open(f, "rb").read() for f in files)
    if len(text) < 1 << 16:
        raise RuntimeError("chip_smoke: the repo's text files are missing")
    lines = text.splitlines(keepends=True)
    pick = rng.integers(0, len(lines), size=2 * q // 8)
    repo = (text + b"".join(lines[i] for i in pick))[:2 * q]
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 10),
                                dtype=np.uint8)) for _ in range(3000)]
    zipf = rng.zipf(1.2, size=2 * q // 3) % len(words)
    prose = b" ".join(words[i] for i in zipf)[:2 * q]
    recs = np.tile(rng.integers(0, 256, size=(64, 64), dtype=np.uint8),
                   (2 * q // 4096 + 1, 1))
    recs = recs[rng.permutation(len(recs))].ravel()[:2 * q]
    noise = rng.integers(0, len(recs), size=len(recs) // 16)
    recs[noise] = rng.integers(0, 256, size=len(noise), dtype=np.uint8)
    ints = np.cumsum(rng.integers(-3, 4, size=q // 4)).astype("<i4")
    rand = rng.integers(0, 256, size=q, dtype=np.uint8)
    corpus = repo + prose + recs.tobytes() + ints.tobytes() + rand.tobytes()
    if len(corpus) != total:
        raise RuntimeError(f"chip_smoke: corpus is {len(corpus)} bytes")
    return corpus


def _median_ms(fn, reps):
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_phase(corpus, dev):
    """Every fold configuration at the path's shape, kernel against the
    plain version on the same inputs."""
    import numpy as np
    import torch

    from brotli_tpu_torch.ops import fold_cuda as F
    row = torch.from_numpy(np.frombuffer(corpus[:ROW], np.uint8)
                           .copy()).to(dev)
    results = {}
    for label, n_keys, n_pay, k_fwd, k_back, fuse, _ in CONFIGS:
        if n_keys == 1:
            ops = F._sort_v0(row, [F.u32_values_at(row, 4 * r)
                                   for r in range(1, n_pay + 1)])
        else:
            ops = F._sort_v0v1(row, n_pay + 2)
        args = dict(min_pos=0, n_keys=n_keys, k_fwd=k_fwd, k_back=k_back,
                    window=WINDOW, lbs=135, len_shift=26, n_real=ROW,
                    fuse_short=fuse)
        packed, score = F.fold_sorted(ops, **args)
        rp, rs = F.fold_sorted_ref(ops, **args)
        torch.cuda.synchronize()
        if not (torch.equal(packed, rp) and torch.equal(score, rs)):
            bad = int((packed != rp).sum() + (score != rs).sum())
            raise AssertionError(f"{label}: kernel != fold_sorted_ref "
                                 f"({bad} words differ)")
        err = max(int((packed.long() - rp.long()).abs().max()),
                  int((score.long() - rs.long()).abs().max()))
        hits = int((packed != 0).sum())
        if hits == 0:
            raise AssertionError(f"{label}: no matches found")
        ms = _median_ms(lambda: F.fold_sorted(ops, **args), 15)
        plain_ms = _median_ms(lambda: F.fold_sorted_ref(ops, **args), 3)
        # bound: each operand read once, two int32 outputs written once;
        # ~5 integer ops per row and offset for the index and v0 test,
        # ~20 more where v0 matches (this input's count)
        nbytes = ROW * (4 * len(ops) + 8)
        idx = torch.arange(ROW, device=dev)
        n_same = 0
        for j in list(range(1, k_fwd + 1)) + [-j for j in
                                              range(1, k_back + 1)]:
            ok = (ops[0] == torch.roll(ops[0], j)) & (idx - j >= 0) \
                & (idx - j < ROW)
            n_same += int(ok.sum())
        nops = 5 * ROW * (k_fwd + k_back) + 20 * n_same
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / INT_OPS_PER_S * 1e3
        results[label] = dict(ms=ms, plain_ms=plain_ms,
                              bound_ms=max(t_bytes, t_ops),
                              bound_by="bytes" if t_bytes >= t_ops
                              else "operations", max_abs_err=err)
        log(f"kernel {label}: equal to fold_sorted_ref on {ROW} rows "
            f"({hits} matches); kernel {ms:.4f} ms, plain {plain_ms:.3f}"
            f" ms, bound {max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f}"
            f" MB, {nops / 1e9:.2f} G int ops)")
        del ops, packed, score, rp, rs
    return results


def match_rounds_phase(corpus, dev):
    """match_rounds at compress_fast's shape: R = 8 rounds of the first
    shard's sorted chunk values (the h4 fold's order) against their
    shift by j = 1, kernel against the plain version."""
    import numpy as np
    import torch

    from brotli_tpu_torch.ops import match_rounds_cuda as MR
    from brotli_tpu_torch.ops import matching as M
    data = torch.from_numpy(np.frombuffer(corpus[:SHARD], np.uint8)
                            .copy()).to(dev)
    vs = [M.u32_values_at(data, 4 * r) for r in range(8)]
    order = torch.argsort(M.mul32(vs[0], M.HASH_MUL32) >> 15, stable=True)
    va = torch.stack([M.as_i32(v) for v in vs])[:, order]
    vb = torch.zeros_like(va)
    vb[:, 1:] = va[:, :-1]
    del vs, order
    got = MR.match_rounds(va, vb)
    want = MR.match_rounds_ref(va, vb)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"match_rounds: kernel != match_rounds_ref "
                             f"({int((got != want).sum())} lengths differ)")
    err = int((got.long() - want.long()).abs().max())
    ms = _median_ms(lambda: MR.match_rounds(va, vb), 15)
    plain_ms = _median_ms(lambda: MR.match_rounds_ref(va, vb), 15)
    # bound: each candidate needs its rounds up to the first unequal one
    # (8 bytes each) and writes 4 bytes; ~6 integer ops per round read
    nz = (va ^ vb) != 0
    first = torch.where(nz.any(0), nz.int().argmax(0) + 1, 8)
    rounds_read = int(first.sum())
    m = va.shape[1]
    nbytes = 8 * rounds_read + 4 * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * rounds_read / INT_OPS_PER_S * 1e3
    hist = torch.bincount(got, minlength=33).tolist()
    log(f"kernel match_rounds: equal to match_rounds_ref at R=8, M={m} "
        f"(lengths 0/4/32: {hist[0]}/{hist[4]}/{hist[32]}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB for "
        f"{rounds_read} rounds read of {8 * m}; all rounds "
        f"{(64 * m + 4 * m) / 1e6:.1f} MB = "
        f"{(68 * m) / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=err)


def _decoder():
    """libbrotlidec's one-shot decode when the machine has it, else the
    port's native decoder."""
    name = ctypes.util.find_library("brotlidec")
    if name is None:
        from brotli_tpu_torch import native_bridge as nb
        return "native", nb.decode
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


def _round_trip(name, decode, out, corpus, what):
    plain = decode(out, len(corpus)) if name == "libbrotlidec" \
        else decode(out)
    if plain != corpus:
        raise AssertionError(f"{what}: {name} round trip differs")


def _report(what, corpus, out, dt, stats):
    log(f"path {what}: {len(corpus) / dt / 1e6:.2f} MB/s, ratio "
        f"{len(corpus) / len(out):.4f} ({len(out)} bytes), "
        f"stats {json.dumps(stats)}")


def path_phase(corpus, dev):
    """Every path on the card over the whole corpus; returns each
    path's launch counts, read just after it ran."""
    import torch

    from brotli_tpu_torch import compress_fast, compress_gpu
    from brotli_tpu_torch.encode import fast as FAST
    from brotli_tpu_torch.ops import fold_cuda as F
    from brotli_tpu_torch.ops import match_rounds_cuda as MR
    name, decode = _decoder()
    launches = {}

    # compress_gpu, q2-q9 tiers
    F.LAUNCHES.clear()
    outs = {}
    for q in (5, 7, 9):
        stats = {}
        t0 = time.perf_counter()
        outs[q] = compress_gpu(corpus, quality=q, lgwin=22, stats=stats,
                               device=dev)
        _report(f"q{q}", corpus, outs[q], time.perf_counter() - t0, stats)
    launches["gpu"] = dict(F.LAUNCHES)
    log(f"path compress_gpu launches: {json.dumps(launches['gpu'])}")
    for q, out in outs.items():
        _round_trip(name, decode, out, corpus, f"q{q}")

    # compress_fast, q0/q1: the host waits on the device matcher from
    # its launch to the compacted records (timed around it, synced)
    match = FAST._gpu_match_compact
    waited = [0.0]

    def timed_match(*a, **kw):
        t0 = time.perf_counter()
        out = match(*a, **kw)
        torch.cuda.synchronize(dev)
        waited[0] += time.perf_counter() - t0
        return out

    full_shards = len(corpus) // SHARD
    MR.LAUNCHES.clear()
    FAST._gpu_match_compact = timed_match
    try:
        outs = {}
        for q in (0, 1):
            before = MR.LAUNCHES.get("match_rounds", 0)
            waited[0] = 0.0
            t0 = time.perf_counter()
            outs[q] = compress_fast(corpus, lgwin=22, quality=q, device=dev)
            dt = time.perf_counter() - t0
            _report(f"compress_fast q{q}", corpus, outs[q], dt,
                    dict(wall_s=dt, device_wait_s=waited[0],
                         device_fraction=waited[0] / dt))
            n = MR.LAUNCHES.get("match_rounds", 0) - before
            if n != 3 * full_shards:
                raise AssertionError(f"compress_fast q{q}: {n} match_rounds"
                                     f" launches, want {3 * full_shards}")
    finally:
        FAST._gpu_match_compact = match
    launches["fast"] = dict(MR.LAUNCHES)
    log(f"path compress_fast launches: {json.dumps(launches['fast'])}")
    for q, out in outs.items():
        _round_trip(name, decode, out, corpus, f"compress_fast q{q}")

    # compress_gpu max_device: match and parse on the device
    F.LAUNCHES.clear()
    outs = {}
    for q in (5, 9):
        stats = {}
        t0 = time.perf_counter()
        outs[q] = compress_gpu(corpus, quality=q, lgwin=22, stats=stats,
                               max_device=True, device=dev)
        _report(f"max_device q{q}", corpus, outs[q],
                time.perf_counter() - t0, stats)
    launches["max_device"] = dict(F.LAUNCHES)
    log(f"path max_device launches: {json.dumps(launches['max_device'])}")
    for q, out in outs.items():
        _round_trip(name, decode, out, corpus, f"max_device q{q}")
    log(f"path round trips: ok through {name}")
    return launches


def cpu_check(corpus, dev):
    from brotli_tpu_torch import compress_fast, compress_gpu
    prefix = corpus[:1 << 20]
    runs = [(f"q{q}", lambda d, q=q: compress_gpu(prefix, quality=q,
                                                   lgwin=22, device=d))
            for q in (5, 7, 9)]
    runs += [(f"compress_fast q{q}",
              lambda d, q=q: compress_fast(prefix, lgwin=22, quality=q,
                                           device=d)) for q in (0, 1)]
    runs += [(f"max_device q{q}",
              lambda d, q=q: compress_gpu(prefix, quality=q, lgwin=22,
                                          max_device=True, device=d))
             for q in (5, 9)]
    for what, run in runs:
        t0 = time.perf_counter()
        a, b = run(dev), run("cpu")
        if a != b:
            raise AssertionError(f"{what}: card and CPU outputs differ on "
                                 "the 1 MiB prefix")
        log(f"cpu check {what}: card == cpu, {len(a)} bytes "
            f"({time.perf_counter() - t0:.1f} s)")


def profile_phase(corpus, dev, quality=9, mib=8):
    """Where one compress_gpu call's time goes: host functions by own
    time (cProfile) and device kernels by device time (torch.profiler),
    with the device's idle share of the call's wall time."""
    import cProfile
    import pstats

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from brotli_tpu_torch import compress_gpu
    data = corpus[:mib << 20]
    compress_gpu(data[:1 << 20], quality=quality, device=dev)  # warm
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    compress_gpu(data, quality=quality, device=dev)
    pr.disable()
    wall = time.perf_counter() - t0
    log(f"profile q{quality} on {mib} MiB: wall {wall:.3f} s; host "
        "functions by own time:")
    st = pstats.Stats(pr)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:12]
    for (fname, line, func), (_, ncalls, tt, ct, _) in rows:
        log(f"  {tt:8.3f} s own {ct:8.3f} s cum {ncalls:6d} calls  "
            f"{os.path.relpath(fname, ROOT) if fname.startswith(ROOT) else fname}"
            f":{line}({func})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compress_gpu(data, quality=quality, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, sets): the aten ops that
    # launched them carry the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if not events:
        log("profile: the trace shows no device time (not measured)")
        return
    log(f"profile device: busy {busy_us / 1e3:.3f} ms of {wall * 1e3:.1f}"
        f" ms wall, idle share {1 - busy_us / 1e6 / wall:.6f}; kernels:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x "
            f"{e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "brotli_tpu_torch")):
        print("chip_smoke: brotli_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build_all()
    log(f"build wall: {time.perf_counter() - t0:.1f} s")
    corpus = make_corpus(CORPUS_MIB, SEED)
    log(f"corpus: {len(corpus)} bytes, seed {SEED}")

    t0 = time.perf_counter()
    timings = kernel_phase(corpus, dev)
    mr_timing = match_rounds_phase(corpus, dev)
    log(f"kernel phase wall: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = path_phase(corpus, dev)
    log(f"path phase wall: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cpu_check(corpus, dev)
    log(f"cpu check wall: {time.perf_counter() - t0:.1f} s")
    profile_phase(corpus, dev)

    from brotli_tpu_torch.ops.fold_cuda import config_name
    kernels = []
    for label, n_keys, n_pay, k_fwd, k_back, fuse, path in CONFIGS:
        if path is None:
            continue
        n = launches[path].get(
            config_name(n_keys, n_pay, k_fwd, k_back, fuse), 0)
        if n == 0:
            raise AssertionError(f"{label}: no launch on its path")
        kernels.append(dict(name=label, route="cuda", source=SRC,
                            replaces=REPLACES, launches=n,
                            library_ms=None, **timings[label]))
    n = launches["fast"].get("match_rounds", 0)
    if n == 0:
        raise AssertionError("match_rounds: no launch on its path")
    kernels.append(dict(name="match_rounds", route="cuda", source=MR_SRC,
                        replaces=MR_REPLACES, launches=n, library_ms=None,
                        **mr_timing))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
