#!/usr/bin/env python3
"""Smoke run of brotli_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # the full run, on one card

Builds the native runtime (native/*.cpp, g++; the run fails unless it
builds and loads, so that no phase but the no-runtime one takes the
pure-Python routes) and the CUDA kernels
(brotli_tpu_torch/csrc/fold.cu, match_rounds.cu, decode_step.cu,
radix_probe.cu and dict_probe.cu, nvcc for sm_90a) side by side, reads the fewest
instructions one step of decode_step executes from its SASS (cuobjdump;
its bound counts the fewer of this and DS_STEP_INSNS, the first port's
floor), makes a
32 MiB corpus from a seed
(brotli_tpu_torch/research/corpus.py: text files of the repo that the
port leaves unchanged, zipf-distributed words, structured records with
noise, slowly varying integers, random bytes), then:

  kernel phase  each fold configuration of compress_gpu on 4,718,592
                sorted rows of the corpus (the row of one 512 KiB span
                at lgwin 22) and compress_mesh's three (q2-6: one key,
                3 payloads, 32/0; q9: the exact9 pair) on 8,388,608
                (a shard's row: 4 MiB halo + 4 MiB shard), and
                match_rounds at R = 8 on the first 4 MiB shard: the
                fold form on the h4 order at k = 2 and on the h8 order
                at k = 1 (as compress_fast runs them), the two-operand
                form on the h4 order against its shift by 1, each with
                the plan launched (match_rounds_cuda.LAST_PLAN), and one
                shard's device matcher by its busy time (devtime.busy_ms):
                each kernel must equal its plain version on the card bit
                for bit; prints
                kernel ms (CUDA events around one launch, median of 15),
                device_ms (the kernel's own duration from torch.profiler,
                median of 15 launches, the L2 flushed by a 128 MiB fill
                before each), burst_ms (events around 50 back-to-back
                launches, over 50), the bound, and the plain version's
                ms; each fold's bound counts the (row, offset) pairs its
                exits leave on these inputs (fold_sorted_exits, which
                must give fold_sorted_ref's outputs too), with the
                first port's all-pairs figure beside it, and the fold
                rows carry the plan launched (fold_cuda.LAST_PLAN) and
                the kernel's ptxas registers and static shared bytes.
                step_probe (TPU probe #9's
                kernel function): the dependent latency of the
                instructions on its chain (decode_gpu.latency_probe) and
                the SM clock, the probe's own run (brotli_tpu_torch/
                research/decode_step_kernel_probe.py, its launches
                counted), then at the probe's shape, 128 lanes x 2048
                steps with 0/1/2 reads, with the plan launched
                (decode_gpu.LAST_PROBE_PLAN) and a latency bound (steps
                x the cycles of a step's critical path at the SM clock);
                and decode_step (the batch
                decoder's symbol loop) on 64 lanes of <= 8 KiB from
                every stream source (compress_fast q1, native q3,
                compress_gpu q3 with static-dictionary references, a
                lane with flipped bits, lanes with codes longer than
                the kernel's root tables), at the full step cap and at
                a small one: each equal to its plain version; with
                decode_step's plan as launched (lanes a CTA, CTAs,
                shared bytes) and microseconds a step of the longest
                lane; and dict_probe (compress_gpu's static-dictionary
                probe) on the rows compress_gpu dispatches: a bulk
                file's 4,718,592-byte row (a whole 512 KiB span at
                lgwin 22) of the corpus in 64 KiB blocks of a seeded
                order and of its repo text, and a web file's row of the
                repo text at lgwin 15 (100,000 real positions of a
                512 KiB span):
                the candidates and the blocks' counts equal to the
                plain version's word for word, the bound (the span's
                real bytes read, 8 bytes a candidate and a count a
                block written), and on the host the numpy probe it
                replaces (static_dict.add_dictionary_matches over the
                same region) and the merge of its candidates
  mirror phase  the fold mirrors of ops/matching.py (plain torch ops,
                no kernel of the port) on the card, through
                brotli_tpu_torch/research/fold_bench.run: the five
                public mirrors at the q5, q7 and q9 settings of
                gpu_path._device_knobs and the exact mirror at
                max_device's q5 and q9, on the 4,718,592-row row
                compress_gpu dispatches for the 512 KiB span at 4 MiB;
                best_matches_exact / exact8 / exact9 must equal the
                CUDA tier wrappers (best_matches_exact_p, ...) bit for
                bit, every mirror's card result its CPU result, and the
                wrappers must have launched the fold; prints each
                mirror's and wrapper's ms (CUDA events around one call,
                median of 5) under the card line, then one
                {"fold_mirrors": [...]} line
  path phase    on the whole corpus at lgwin 22: compress_gpu at q5,
                q7 and q9; compress_fast at q0 and q1; compress_gpu
                max_device at q5 and q9.  Each path's launch counters
                are set to 0 just before it and read just after, and
                each path must have launched each of its kernels
                (compress_fast: the fold form of match_rounds twice a
                full shard, once at k = 2 and once at k = 1;
                compress_gpu: dict_probe once a span, and never with
                max_device); every
                output must decode back (libbrotlidec when present,
                else the port's native decoder); max_device's q5 and q9
                again with the card's parse held, span by span, to the
                plain walk of perfbench/plain_parse.py over the card's
                fold outputs (perfbench/card_parse.py), the stream equal
                to the timed call's
  mesh phase    compress_mesh over 8 shards of 4 MiB (each behind a
                4 MiB halo) on the card at lgwin 22, q5 and q9: the
                fold's launch counts set to 0 just before each call and
                read just after (each fold of the tier once a shard),
                MB/s, ratio and the host's wait on the device; each call
                again under a CUDA activity trace for the folds' device
                ms a shard and the idle share, and q9 once more under
                cProfile for the host's functions by own time; every
                output must decode back
  host encoder  the host encoder (no kernel; the card's machine's CPU,
                without the JAX package's malloc tuning): compress at
                q0, q1, q2, q3 and q5 on the whole corpus and at q9 on
                its first 8 MiB; compress_multi with 8 parts at q5 and
                q9 on the thread, serial and workpool backends (serial
                must equal thread); compress_batch at q5 on 256 slices
                of 64 KiB; compress_mesh over 8 shards on an input
                under 8 x 4096 bytes, which must equal compress on it;
                MB/s (one call on the host clock) and ratio for each
                under the card line; every output must decode back
  decode path   decompress_batch_gpu on a serving batch (1024 streams
                of 64 KiB: half compress_fast q1, half native q3), a
                multi-round batch (8 streams of 8 MiB through
                compress_fast: two 4 MiB metablocks, two device rounds)
                and a fallback batch (16 streams of 64 KiB at native
                q11, context-modeled, all decoded on the host), slices
                of the corpus's first 24 MiB; outputs equal inputs,
                n_device is 1024 / 8 / 0 and decode_step launches once
                per device round; prints decoded MB/s, each round's ms
                (CUDA events, the wrapper's host work included) and
                its kernel's device ms (the round's launch again,
                profiled), steps per lane, microseconds a step of the
                longest lane on device time, the plan launched and
                the share of the call spent waiting on the device;
                then decode_step
                against its
                plain version in all seven outputs and the step counts
                on all 1024 of the serving batch's lanes, with the
                arrays, step cap and buffer sizes the path gives it
  optimal parser the host encoder's optimal parser and the host
                decoders (no kernel; the card machine's CPU): compress
                at q11 and q10 on the corpus's first 8 MiB; q9_5 at
                quality 10 on one 1 MiB slice (a single metablock: the
                overlapped tier, which must produce the stream);
                compress_multi with 8 parts at q11 on the 8 MiB on the
                thread, serial (must equal thread) and workpool
                backends; compress_batch at q11 on 64 slices of 64 KiB;
                MB/s (one call on the host clock) and ratio for each
                under the card line; every output decodes back through
                libbrotlidec and through the port's decompress; the
                port's pure-Python Decoder decodes a 256 KiB q11 stream
                made with a custom dictionary and one made with a
                large window (lgwin 26), with its MB/s; prints the
                phase's wall
  streaming     the streaming layer (no kernel; the card machine's
                CPU): the Compressor at q5 over the corpus in 64 KiB
                pieces (its default chunk, flush every 4 MiB, one
                metadata block), at q9 on the first 8 MiB and at q11 on
                the first MiB, each beside one-shot compress (q5 and q9
                within 0.5% of it); the pure-Python StreamDecoder on 1
                MiB of the repo's text in 4 KiB pieces with max_output
                65536 (its kept window bounded) and on 64 KiB one byte
                at a time; CompressorWriter on 8 MiB, a Decompressor
                reading 512 KiB back in 4 KiB reads, CompressorReader
                and DecompressorWriter; the FFI: an encoder instance
                (PROCESS, FLUSH, EMIT_METADATA, FINISH, TakeOutput in 4
                KiB bites), CompressPrealloc, DecompressWithReturnInfo
                on the corpus's q5 stream, a decoder instance on 512
                KiB, and a corrupt stream giving the error result; MB/s
                and ratio for each under the card line; every stream
                decodes back through libbrotlidec and decompress;
                prints the phase's wall
  tools         the tools (no kernel; the card machine's CPU): the
                port's brotli CLI: -c -q9 on the corpus's first 8 MiB
                file to file (one python3 -m subprocess) and back by
                decompression, -c -q5 -j8 -validate on the whole corpus,
                -c -q11 on its first MiB, -b3 -c -q5 on 8 MiB (its own
                timing line checked), -i, -findprior, -findspeed and
                -advstride on 1 MiB, all but the first through main(argv)
                in this process; catbrotli (one python3 -m subprocess)
                on four -catable parts of 2 MiB, decoded against their
                join; billing.account on a 512 KiB q9 stream of the
                repo's text, its bits within 7 of 8 x the stream's
                length; the route of the blocks the native store
                refuses: compress q5 at lgblock 16 with the metablock
                callback on 2 MiB of low-entropy bytes, every block
                planned by the pure-Python planner (counted); MB/s and
                ratio for each under the card line; every stream decodes
                back through libbrotlidec and decompress.  The host
                encoder, streaming and tools phases each print their
                wall and the metablocks the native stores refused in
                them (Refusals)
  no-runtime    the no-runtime mode (brotli_tpu_torch/research/
                no_runtime.py) in a child process with
                BROTLI_TPU_TORCH_NO_NATIVE=1, nothing of native/ loaded
                there: on the card, compress_gpu at q5 and q9 on 1 MiB
                in two 512 KiB spans (the on-device inversion) and
                max_device at q5, compress_mesh at q5 over 8 shards of
                128 KiB, compress_fast at q1 on 512 KiB, and
                decompress_batch_gpu on the serving batch's first 64
                streams, each behind its pure-Python host leg; on the
                CPU, compress at q1, q5 and q11, the Compressor at q5
                and compress_multi(backend="workpool") on 256 KiB; each
                input a quarter from the head of each quarter of the
                corpus.  MB/s, ratio and the fold, match_rounds and
                decode_step launches of each call (each kernel must
                have launched); every stream decodes back through
                libbrotlidec; card == CPU for each device path at 128
                KiB; ops/bitpack.pack_bits_u32 on the card equal to the
                numpy pack_bits on one metablock's bit items; the
                child's native_bridge._lib is None at its end
  cpu check     each path on the card equals the same path with
                device="cpu" byte for byte on a 1 MiB prefix
                (compress_mesh at q5 and q9 over 8 shards), and
                decompress_batch_gpu on the card equals device="cpu" on
                32 streams of 4 KiB
  radix phase   the radix probes (brotli_tpu_torch/research/
                radix_probe.py and radix_probe2.py, counterparts of
                research/radix_probe*.py) run on a 5 MiB corpus from the
                seed, their launch counters set to 0 just before and
                read just after (each primitive must have launched);
                prints both result dicts; then each primitive
                (gather_rows at R = 8 ... 8192, gather_lanes, hist8,
                run_copy, cmpex3) against its plain version at the
                probes' shape, int32 [40960, 128]: kernel, plain and
                torch.gather ms, device_ms and burst_ms, the bound and
                the host us a call of the wrapper (1,000 calls, no
                synchronize); for the gathers and hist8 also the route
                and grid they launched with (hist8: CTAs, cluster size,
                shared bytes), for the gathers the host us of
                torch.gather
  profile       where one q9 call on 8 MiB spends its time: host
                functions by own time (cProfile), device kernels by
                device time and the device's idle share (torch.profiler)

Every row of the kernels line carries ms, device_ms, burst_ms and
device_bound_share (bound_ms / device_ms: a cold L2 keeps it at or
under 1); the folds' rows also plan, ptxas, pairs, pairs_share,
longest_lane_share, bound_ms_all_pairs and rows; the radix rows also
host_us, the gathers' also library_device_ms, library_burst_ms,
library_host_us and grid, hist8's also grid; decode_step's also grid
(its plan), per_step_us, sass_step_floor and bound_ms_at_360;
dict_probe's also plan, ptxas, positions, candidates, won_vs_none,
host_numpy_ms, host_merge_ms and launches_by_quality; match_rounds' also plan and rounds (the fold
form's also words, bound_ms_two_operand and, at k = 2, the matcher's
matcher_busy_ms); step_probe's also grid, latency_bound_ms and
step_cycles.  The line before the last is
{"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero;
without CUDA, or without the package beside this script, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from brotli_tpu_torch.research.decode_batches import (
    DECODE_SPAN, MULTI_STREAMS, SERVE_BYTES, SERVE_STREAMS, lanes_of,
    multi_round_batch, native_encoder, serving_batch)
from brotli_tpu_torch.research.devtime import (busy_ms, device_ms,
                                               device_times, host_us,
                                               median_ms)
from brotli_tpu_torch.research.fold_ab import (CONFIGS, ROW, fold_args,
                                               sorted_ops)

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
INT_OPS_PER_S = 67e12       # non-tensor 32-bit peak (FP32 rate)
SRC = "brotli_tpu_torch/csrc/fold.cu"
REPLACES = "brotli_tpu/ops/fold_pallas.py:250"
MR_SRC = "brotli_tpu_torch/csrc/match_rounds.cu"
MR_REPLACES = "brotli_tpu/ops/pallas_match.py:62"
DS_SRC = "brotli_tpu_torch/csrc/decode_step.cu"
DP_SRC = "brotli_tpu_torch/csrc/dict_probe.cu"
DP_REPLACES = ("none (brotli_tpu/encode/static_dict.py:"
               "add_dictionary_matches, numpy on the host)")
DS_REPLACES = "brotli_tpu/ops/decode_tpu.py:450"
SP_REPLACES = "research/decode_step_kernel_probe.py:94"
RP_SRC = "brotli_tpu_torch/csrc/radix_probe.cu"
# the fewest instructions one trip of the first port's decode_step loop
# executes (sass_step_floor of csrc/decode_step.cu at commit 9b1ccfd,
# built for an H100).  decode_step's bound counts the fewer of this and
# the current build's own floor a step, so that it stays a lower bound
# for the function; the bound at this fixed count is printed beside it.
DS_STEP_INSNS = 360
RADIX_MIB = 5               # the probes' N = 5,242,880 bytes
PROBE_LANES, PROBE_STEPS = 128, 2048
FALLBACK_STREAMS = 16
SHARD = 1 << 22             # compress_fast's shard
CORPUS_MIB = 32
SEED = 20261016
MESH_SHARDS = 8             # compress_mesh: 8 shards of 4 MiB
HOST_Q9_MIB = 8             # the host encoder's q9 on the corpus's head
HOST_BATCH = 256            # compress_batch: slices of 64 KiB
HOST_ZOPFLI_MIB = 8         # the optimal parser on the corpus's head
STREAM_Q9_MIB = 8           # the streaming phase's q9, io and FFI inputs
STREAM_FLUSH_MIB = 4        # the streaming Compressor flushes this often
ZOPFLI_BATCH = 64           # compress_batch at q11: slices of 64 KiB
TOOLS_MIB = 8               # the tools phase's -q9 / -b3 input (the head)
TOOLS_SMALL_MIB = 1         # its -q11, -i, -findprior, -findspeed, -advstride
TOOLS_PART_MIB = 2          # its four -catable parts
TOOLS_BILL_KIB = 512        # billing.account's q9 stream
TOOLS_REFUSED_MIB = 2       # the low-entropy input the native store refuses
NO_RUNTIME_TIMEOUT = 600    # the no-runtime phase's child process, seconds
MESH_ROW = 8 << 20          # a shard row: a 4 MiB halo and 4 MiB shard
# dict_probe's rows: (name, source, row bytes, halo, real, min_pos,
# window); "mixed" is the corpus in 64 KiB blocks of a seeded order,
# "text" the corpus's head (repo text)
DP_ROWS = [("bulk", "mixed", ROW, ROW - (1 << 19), 1 << 19, 0,
            (1 << 22) - 16),
           ("text", "text", ROW, ROW - (1 << 19), 1 << 19, 0,
            (1 << 22) - 16),
           ("web", "text", (1 << 15) + (1 << 19), 1 << 15, 100_000,
            1 << 15, (1 << 15) - 16)]
# compress_mesh's folds by quality (fold_cuda.config_name)
MESH_FOLDS = {5: ["fold_k1p3_f32b0"],
              9: ["fold_k2p2_f16b8", "fold_k1p1_f16b0"]}
# the folds at ROW rows, and the mesh's at MESH_ROW (fold_ab.CONFIGS'
# entries; the q9 pair is compress_gpu's q9 configuration on the mesh's
# longer row)
ROW_CONFIGS = [c for c in CONFIGS if c[6] != "mesh"]
MESH_CONFIGS = [c for c in CONFIGS if c[6] == "mesh"] + [
    ("fold mesh q9 main", 2, 2, 16, 8, False, "mesh"),
    ("fold mesh q9 short", 1, 1, 16, 0, False, "mesh")]

def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def build_all():
    """Native runtime and the five CUDA kernel sources, compiled side by
    side; returns the paths of the built decode_step, fold and
    dict_probe libraries."""
    from brotli_tpu_torch import native_bridge as nb
    from brotli_tpu_torch.ops import (decode_gpu, dict_probe_cuda,
                                      fold_cuda, match_rounds_cuda,
                                      radix_cuda)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    builds = {"native": nb.build, "fold.cu": fold_cuda.LIB.build,
              "match_rounds.cu": match_rounds_cuda.LIB.build,
              "decode_step.cu": decode_gpu.LIB.build,
              "radix_probe.cu": radix_cuda.LIB.build,
              "dict_probe.cu": dict_probe_cuda.LIB.build}
    with ThreadPoolExecutor(len(builds)) as ex:
        futs = {k: ex.submit(timed, fn) for k, fn in builds.items()}
        done = {k: f.result() for k, f in futs.items()}
    log("build: " + ", ".join(f"{k} {t:.1f} s" for k, (_, t) in
                              done.items()))
    for k in ("fold.cu", "match_rounds.cu", "decode_step.cu",
              "radix_probe.cu", "dict_probe.cu"):
        fn = "?"
        for ln in done[k][0][1].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                fn = _kernel_name(m.group(1))
            elif "registers" in ln or "stack frame" in ln:
                log(f"  ptxas {k} {fn}:", ln.strip().removeprefix(
                    "ptxas info    : "))
    return (done["decode_step.cu"][0][0], done["fold.cu"][0][0],
            done["dict_probe.cu"][0][0])


def resource_usage(lib_path: str) -> dict:
    """Each kernel's registers, shared bytes and stack bytes from
    `cuobjdump -res-usage` of the built library: kernel name
    (_kernel_name) -> dict.  Its shared bytes (SHARED) are the static
    shared memory plus the 1 KB an sm_90 CTA reserves; the dynamic
    bytes are the plan's."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-res-usage", lib_path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for chunk in text.split("Function ")[1:]:
        name = _kernel_name(chunk.split(":", 1)[0].strip())
        rep = {}
        for key, pat in (("registers", r"REG:(\d+)"),
                         ("res_shared_bytes", r"SHARED:(\d+)"),
                         ("stack_bytes", r"STACK:(\d+)")):
            if (v := re.search(pat, chunk)):
                rep[key] = int(v.group(1))
        out[name] = rep
    return out


def _kernel_name(mangled: str) -> str:
    """gather_rows_smem_kernel<128> from its mangled name (the name and
    any integer template arguments)."""
    at = 3 if mangled.startswith("_ZN") else 2
    while (m := re.match(r"\d+", mangled[at:])):
        start = at + m.end()
        at = start + int(m.group())
        name = mangled[start:at]
        if name.endswith("_kernel"):
            t = re.match(r"I(\w*?)EE", mangled[at:])
            args = re.findall(r"L[a-z](-?\d+)E",
                              t.group(1) + "E" if t else "")
            return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def sass_step_floor(lib_path: str, kernel: str = "decode_step_kernel"):
    """The fewest SASS instructions one trip of `kernel`'s step loop can
    execute, from `cuobjdump -sass` of the built library: the kernel's
    control-flow graph (branch targets and fall-throughs), the loop head
    as the target of its widest backward branch, and the shortest cycle
    through that head (breadth-first, one instruction a node).  Returns
    (instructions per trip at least, the kernel's instructions)."""
    from collections import deque
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    insns, inside = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            if insns:
                break   # the kernel's listing ends at the next function
            inside = kernel in ln
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if inside and m:
            insns.append((int(m.group(1), 16), m.group(2).strip()))
    if not insns:
        raise AssertionError(f"sass: no instructions of {kernel} in "
                             f"{lib_path}")
    index = {a: k for k, (a, _) in enumerate(insns)}
    succ, back = [], []
    for k, (addr, text) in enumerate(insns):
        guarded = text.startswith("@") and not text.startswith("@PT ")
        op = text.split()[1 if text.startswith("@") else 0]
        nxt = [k + 1] if k + 1 < len(insns) else []
        if op.startswith(("BRX", "JMX")):
            raise AssertionError(f"sass: indirect branch at {addr:#x}")
        if op.startswith("BRA"):
            tgt = index[int(re.findall(r"0x([0-9a-f]+)", text)[-1], 16)]
            # an unguarded BRA with a predicate operand is conditional too
            cond = guarded or "," in text
            succ.append([tgt] + (nxt if cond else []))
            if tgt <= k:
                back.append((k - tgt, tgt))
        elif op.startswith(("EXIT", "RET")):
            succ.append(nxt if guarded else [])
        else:
            succ.append(nxt)
    if not back:
        raise AssertionError(f"sass: {kernel} has no loop")
    head = max(back)[1]
    dist = {head: 1}
    queue = deque([head])
    while queue:
        u = queue.popleft()
        for v in succ[u]:
            if v == head:
                return dist[u], len(insns)
            if v not in dist:
                dist[v] = dist[u] + 1
                queue.append(v)
    raise AssertionError(f"sass: no path around {kernel}'s loop")


def kernel_phase(corpus, dev, fold_ptxas, configs, rows):
    """Each fold configuration of `configs` on the sorted operands of
    the corpus's first `rows` bytes, kernel against the plain version on
    the same inputs."""
    import numpy as np
    import torch

    from brotli_tpu_torch.ops import fold_cuda as F
    row = torch.from_numpy(np.frombuffer(corpus[:rows], np.uint8)
                           .copy()).to(dev)
    results = {}
    for label, n_keys, n_pay, k_fwd, k_back, fuse, _ in configs:
        ops = sorted_ops(row, n_keys, n_pay)
        args = fold_args(n_keys, k_fwd, k_back, fuse, rows)
        packed, score = F.fold_sorted(ops, **args)
        plan = dict(F.LAST_PLAN)
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
        # the pairs the kernel's exits leave (fold_sorted_exits: the same
        # rule as csrc/fold.cu, and its outputs must be the fold's)
        ep, es, pairs = F.fold_sorted_exits(ops, **args)
        if not (torch.equal(ep, rp) and torch.equal(es, rs)):
            raise AssertionError(f"{label}: fold_sorted_exits != "
                                 "fold_sorted_ref")
        n_pairs = int(pairs.sum())
        # with one lane a row a warp runs as long as its longest lane:
        # the pairs 32 consecutive rows take then, over all pairs
        longest = int(pairs[:rows // 32 * 32].view(-1, 32).max(1).values
                      .sum()) * 32
        ms = median_ms(lambda: F.fold_sorted(ops, **args), 15)
        dt = device_times(lambda: F.fold_sorted(ops, **args), "fold_kernel")
        plain_ms = median_ms(lambda: F.fold_sorted_ref(ops, **args), 3)
        # bound: each operand read once, two int32 outputs written once;
        # ~20 integer ops for each (row, offset) pair the exits leave.
        # bound_ms_all_pairs: the first port's count, ~5 ops for every
        # pair and ~20 more where v0 matches
        nbytes = rows * (4 * len(ops) + 8)
        idx = torch.arange(rows, device=dev)
        n_same = 0
        for j in list(range(1, k_fwd + 1)) + [-j for j in
                                              range(1, k_back + 1)]:
            ok = (ops[0] == torch.roll(ops[0], j)) & (idx - j >= 0) \
                & (idx - j < rows)
            n_same += int(ok.sum())
        all_ops = 5 * rows * (k_fwd + k_back) + 20 * n_same
        nops = 20 * n_pairs
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / INT_OPS_PER_S * 1e3
        kname = (f"fold_kernel<{n_keys},{n_pay},{int(fuse)},"
                 f"{int(plan['route'] == 'compact')}>")
        if "registers" not in fold_ptxas.get(kname, {}):
            raise AssertionError(f"{label}: no resource usage of {kname} "
                                 "in the fold library")
        results[label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bound_ms_all_pairs=max(t_bytes,
                                   all_ops / INT_OPS_PER_S * 1e3),
            pairs=n_pairs, pairs_share=n_pairs / (rows * (k_fwd + k_back)),
            longest_lane_share=longest / (rows * (k_fwd + k_back)),
            max_abs_err=err, plan=plan,
            ptxas=dict(kernel=kname, **fold_ptxas[kname]), **dt)
        results[label]["rows"] = rows
        log(f"kernel {label}: equal to fold_sorted_ref on {rows} rows "
            f"({hits} matches); kernel {ms:.4f} ms (device "
            f"{dt['device_ms']:.4f}, burst {dt['burst_ms']:.4f}), plain "
            f"{plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} G int ops for "
            f"{n_pairs} pairs the exits leave, "
            f"{n_pairs / (rows * (k_fwd + k_back)):.4f} of all, a warp's "
            f"longest lane {longest / (rows * (k_fwd + k_back)):.4f}; all "
            f"pairs {results[label]['bound_ms_all_pairs']:.4f} ms); plan "
            f"{json.dumps(plan)}; ptxas {json.dumps(results[label]['ptxas'])}")
        del ops, packed, score, rp, rs, ep, es, pairs
    return results


def dict_probe_phase(corpus, dev, dp_ptxas):
    """The static-dictionary probe on each of DP_ROWS, kernel against
    the plain version on the same row; on the host, the numpy probe it
    replaces and the merge of its output.  Returns each row's entry."""
    import numpy as np
    import torch

    from brotli_tpu_torch.encode.static_dict import add_dictionary_matches
    from brotli_tpu_torch.ops import dict_probe_cuda as DP
    if "registers" not in dp_ptxas.get("dict_probe_kernel", {}):
        raise AssertionError("no resource usage of dict_probe_kernel in "
                             "the dict_probe library")
    text = np.frombuffer(corpus, np.uint8)
    blocks = text.reshape(-1, 1 << 16)
    sources = {"text": text, "mixed": blocks[np.random.default_rng(SEED)
                                             .permutation(len(blocks))]
               .ravel()}

    def host_ms(fn, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[reps // 2]

    results = {}
    for name, src, n, halo, real, min_pos, window in DP_ROWS:
        row = sources[src][:n].copy()
        row[halo + real:] = 0          # a short last span's zero tail
        row_d = torch.from_numpy(row).to(dev)

        def kern():
            return DP.dict_probe(row_d, halo, real, min_pos, window)

        def plain():
            return DP.dict_probe_ref(row_d, halo, real, min_pos, window)

        out = kern().cpu().numpy()
        plan = DP.probe_plan(n - halo)
        got, want = DP.candidates(out), DP.candidates(plain().cpu().numpy())
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"dict_probe {name}: kernel != "
                                 "dict_probe_ref in its candidates or "
                                 "counts")
        cand = len(got[1])
        if cand == 0:
            raise AssertionError(f"dict_probe {name}: no candidates")
        zeros = np.zeros(real, np.int64)
        won = DP.merge_candidates(out, zeros.copy(), zeros.copy(),
                                  zeros.copy())[2]
        ms = median_ms(kern, 15)
        dt = device_times(kern, "dict_probe_kernel")
        plain_ms = median_ms(plain, 5)
        # bound: the span's real bytes read once; 8 bytes a candidate and
        # a count a block written (the index stays in L2)
        bound_ms, by = _bound(real + 8 * (cand + plan["ctas"]), 0)
        region, dlen = row[min_pos:halo + real], halo - min_pos

        def numpy_probe():
            arrs = [np.zeros(dlen + real, np.int64) for _ in range(3)] + [
                np.zeros(dlen + real, bool), np.zeros(dlen + real, np.int64)]
            add_dictionary_matches(region, dlen, window, 135, *arrs)

        results[name] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            max_abs_err=0, plan=plan,
            ptxas=dict(kernel="dict_probe_kernel",
                       **dp_ptxas["dict_probe_kernel"]),
            positions=real, candidates=cand, won_vs_none=won,
            host_numpy_ms=host_ms(numpy_probe, 3),
            host_merge_ms=host_ms(lambda: DP.merge_candidates(
                out, zeros.copy(), zeros.copy(), zeros.copy()), 15), **dt)
        log(f"kernel dict_probe {name}: equal to dict_probe_ref on "
            f"{real} positions of a {n}-byte row ({cand} candidates, "
            f"{won} taken against no window match); kernel {ms:.4f} ms "
            f"(device {dt['device_ms']:.5f}, burst {dt['burst_ms']:.4f}), "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({by}); "
            f"host: numpy probe {results[name]['host_numpy_ms']:.2f} ms, "
            f"merge {results[name]['host_merge_ms']:.3f} ms; plan "
            f"{json.dumps(plan)}; ptxas {json.dumps(results[name]['ptxas'])}")
        del row_d
    return results


def match_rounds_phase(corpus, dev):
    """match_rounds at compress_fast's shape, R = 8 rounds of the first
    shard's sorted chunk values: the fold form on the h4 order at k = 2
    and on the h8 order at k = 1 (one launch each, as compress_fast runs
    them), and the two-operand form on the h4 order against its shift by
    1; each kernel against its plain version.  Then one shard's device
    matcher (_gpu_match_compact) by its device busy time.  Returns, per
    kernel, (its name in the kernels line, its key in
    match_rounds_cuda.LAUNCHES, its entry)."""
    import numpy as np
    import torch

    from brotli_tpu_torch.encode import fast as FAST
    from brotli_tpu_torch.ops import match_rounds_cuda as MR
    from brotli_tpu_torch.research.match_rounds_ab import (FOLDS,
                                                           rounds_needed,
                                                           sorted_rounds)
    data = torch.from_numpy(np.frombuffer(corpus[:SHARD], np.uint8)
                            .copy()).to(dev)
    ops = sorted_rounds(data)
    rounds, m = ops["h4"].shape

    def compare(what, kern, plain, kname):
        got = kern()
        plan = dict(MR.LAST_PLAN)
        want = plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel != plain version "
                                 f"({int((got != want).sum())} lengths "
                                 "differ)")
        err = int((got.long() - want.long()).abs().max())
        ms = median_ms(kern, 15)
        dt = device_times(kern, kname)
        plain_ms = median_ms(plain, 15)
        return got, plan, dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                               **dt)

    results = []
    # the fold form: bound = each va word some chain needs, once, and 4k
    # bytes a row written; bound_ms_two_operand = 8 bytes a needed round
    # (the two-operand form's reads) and the same writes; ~6 integer ops
    # a needed round
    for name, k in FOLDS:
        va = ops[name]
        got, plan, t = compare(
            f"match_rounds_shifted {name} k={k}",
            lambda va=va, k=k: MR.match_rounds_shifted(va, k),
            lambda va=va, k=k: MR.match_rounds_shifted_ref(va, k),
            "match_rounds_shifted_kernel")
        need, words = rounds_needed(va, k)
        n_rounds = int(need.sum())
        bound_ms, by = _bound(4 * words + 4 * k * m, 6 * n_rounds)
        two_ms = _bound(8 * n_rounds + 4 * k * m, 6 * n_rounds)[0]
        hist = torch.bincount(got[0], minlength=33).tolist()
        label = f"match_rounds_shifted k={k}"
        results.append((label, f"match_rounds_shifted_k{k}", dict(
            bound_ms=bound_ms, bound_by=by, bound_ms_two_operand=two_ms,
            plan=plan, words=words, rounds=n_rounds, **t)))
        log(f"kernel {label}: equal to match_rounds_shifted_ref on the "
            f"{name} order, R={rounds}, M={m} (j=1 lengths 0/4/32: "
            f"{hist[0]}/{hist[4]}/{hist[32]}); kernel {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}, burst {t['burst_ms']:.4f}), "
            f"plain {t['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms ({by}: "
            f"{words} words of {rounds * m} some chain needs, "
            f"{n_rounds} rounds the {k} chains need; two-operand bytes "
            f"{two_ms:.4f} ms); plan {json.dumps(plan)}")

    # the two-operand form at j = 1: 8 bytes a needed round, 4 written
    va = ops["h4"]
    vb = MR.shift_rounds(va, 1)
    got, plan, t = compare("match_rounds j=1",
                           lambda: MR.match_rounds(va, vb),
                           lambda: MR.match_rounds_ref(va, vb),
                           "match_rounds_kernel")
    n_rounds = int(rounds_needed(va, 1)[0].sum())
    bound_ms, by = _bound(8 * n_rounds + 4 * m, 6 * n_rounds)
    results.append(("match_rounds", "match_rounds", dict(
        bound_ms=bound_ms, bound_by=by, plan=plan, rounds=n_rounds, **t)))
    log(f"kernel match_rounds: equal to match_rounds_ref at R={rounds}, "
        f"M={m}, the h4 order against its shift by 1; kernel "
        f"{t['ms']:.4f} ms (device {t['device_ms']:.4f}, burst "
        f"{t['burst_ms']:.4f}), plain {t['plain_ms']:.3f} ms, bound "
        f"{bound_ms:.4f} ms ({by}: {n_rounds} rounds read of {rounds * m});"
        f" plan {json.dumps(plan)}")
    del ops, va, vb, got

    # one shard's device matcher, sorts and compaction included
    busy = busy_ms(lambda: FAST._gpu_match_compact(data, (1 << 22) - 16))
    log(f"matcher: one 4 MiB shard's _gpu_match_compact, device busy "
        f"{busy:.4f} ms (median of 15, cold L2)")
    results[0][2]["matcher_busy_ms"] = busy
    return results


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
    scalars = {k: v for k, v in stats.items() if k != "spans"}
    log(f"path {what}: {len(corpus) / dt / 1e6:.2f} MB/s, ratio "
        f"{len(corpus) / len(out):.4f} ({len(out)} bytes), "
        f"stats {json.dumps(scalars)}")


def mirror_phase(corpus, dev, card):
    """The fold mirrors against the CUDA tier wrappers and against
    their CPU results (research/fold_bench.py) on compress_gpu's row
    for the span at 4 MiB (the corpus's first ROW bytes); the fold's
    launch counts set to 0 just before and read just after."""
    import numpy as np
    import torch

    from brotli_tpu_torch.ops import fold_cuda as F
    from brotli_tpu_torch.research import fold_bench
    log(f"mirror phase on {card}")
    row = torch.from_numpy(np.frombuffer(corpus[:ROW], np.uint8).copy())
    F.LAUNCHES.clear()
    res = fold_bench.run(dev, row.to(dev), log=log)
    launched = dict(F.LAUNCHES)
    if not launched:
        raise AssertionError("mirror phase: no fold launch of a tier "
                             "wrapper")
    log(f"mirror phase fold launches: {json.dumps(launched)}")
    log(card)
    log(json.dumps({"fold_mirrors": res}))


def path_phase(corpus, dev):
    """Every path on the card over the whole corpus; returns each
    path's launch counts, read just after it ran."""
    import torch

    from brotli_tpu_torch import compress_fast, compress_gpu
    from brotli_tpu_torch.encode import fast as FAST
    from brotli_tpu_torch.ops import dict_probe_cuda as DP
    from brotli_tpu_torch.ops import fold_cuda as F
    from brotli_tpu_torch.ops import match_rounds_cuda as MR
    name, decode = _decoder()
    launches = {"dict_probe": {}}

    # compress_gpu, q2-q9 tiers: dict_probe once a span
    F.LAUNCHES.clear()
    outs = {}
    for q in (5, 7, 9):
        stats = {}
        DP.LAUNCHES = 0
        t0 = time.perf_counter()
        outs[q] = compress_gpu(corpus, quality=q, lgwin=22, stats=stats,
                               device=dev)
        _report(f"q{q}", corpus, outs[q], time.perf_counter() - t0, stats)
        spans = [s[0] for s in stats["spans"]].count("host_parse")
        if DP.LAUNCHES != spans or spans == 0:
            raise AssertionError(f"compress_gpu q{q}: {DP.LAUNCHES} "
                                 f"launches of dict_probe, want {spans}")
        launches["dict_probe"][f"q{q}"] = DP.LAUNCHES
    launches["gpu"] = dict(F.LAUNCHES)
    log(f"path compress_gpu launches: {json.dumps(launches['gpu'])}, "
        f"dict_probe {json.dumps(launches['dict_probe'])}")
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
            before = MR.LAUNCHES.get("match_rounds_shifted", 0)
            waited[0] = 0.0
            t0 = time.perf_counter()
            outs[q] = compress_fast(corpus, lgwin=22, quality=q, device=dev)
            dt = time.perf_counter() - t0
            _report(f"compress_fast q{q}", corpus, outs[q], dt,
                    dict(wall_s=dt, device_wait_s=waited[0],
                         device_fraction=waited[0] / dt))
            # one fold-form launch per fold: h4 (k = 2) and h8 (k8 = 1)
            n = MR.LAUNCHES.get("match_rounds_shifted", 0) - before
            if n != 2 * full_shards:
                raise AssertionError(f"compress_fast q{q}: {n} launches of "
                                     "match_rounds_shifted, want "
                                     f"{2 * full_shards}")
    finally:
        FAST._gpu_match_compact = match
    launches["fast"] = dict(MR.LAUNCHES)
    log(f"path compress_fast launches: {json.dumps(launches['fast'])}")
    for q, out in outs.items():
        _round_trip(name, decode, out, corpus, f"compress_fast q{q}")

    # compress_gpu max_device: match and parse on the device, no
    # dictionary probe
    F.LAUNCHES.clear()
    DP.LAUNCHES = 0
    outs = {}
    for q in (5, 9):
        stats = {}
        t0 = time.perf_counter()
        outs[q] = compress_gpu(corpus, quality=q, lgwin=22, stats=stats,
                               max_device=True, device=dev)
        _report(f"max_device q{q}", corpus, outs[q],
                time.perf_counter() - t0, stats)
    if DP.LAUNCHES != 0:
        raise AssertionError(f"max_device: {DP.LAUNCHES} launches of "
                             "dict_probe, want 0")
    launches["dict_probe"]["max_device"] = DP.LAUNCHES
    launches["max_device"] = dict(F.LAUNCHES)
    log(f"path max_device launches: {json.dumps(launches['max_device'])}")
    for q, out in outs.items():
        _round_trip(name, decode, out, corpus, f"max_device q{q}")
    # the card's parse against the plain walk, untimed: the spans' fold
    # outputs are copied back as they pass
    sys.path.append(os.path.join(ROOT, "perfbench"))
    import card_parse
    for q, out in outs.items():
        again, fig = card_parse.checked_compress(corpus, quality=q,
                                                 lgwin=22, device=dev)
        if again != out:
            raise AssertionError(f"max_device q{q}: the checked call's "
                                 "stream differs from the timed call's")
        log(f"path max_device q{q}: parse equal to perfbench/"
            f"plain_parse.py on {fig['spans']} spans ({fig['commands']} "
            f"commands; copies cover {fig['copied']} of "
            f"{fig['positions']} positions, "
            f"{100 * fig['copied'] / fig['positions']:.4f}%)")
    log(f"path round trips: ok through {name}")
    return launches


def mesh_phase(corpus, dev):
    """compress_mesh over MESH_SHARDS shards of the whole corpus at
    lgwin 22, q5 and q9 (each shard row a 4 MiB halo plus its 4 MiB),
    all on the card; the fold's launch counts set to 0 just before each
    call and read just after, and every shard must have launched each
    fold of its tier.  Each call again under a CUDA activity trace for
    the folds' device ms a shard and the device's idle share.  Every
    output must decode back.  Returns the launch counts of both calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from brotli_tpu_torch import compress_mesh, make_mesh
    from brotli_tpu_torch.ops import fold_cuda as F
    name, decode = _decoder()
    mesh = make_mesh(MESH_SHARDS)
    if {d.type for d in mesh} != {"cuda"}:
        raise AssertionError(f"mesh: shards not on the card: {mesh}")
    launches, outs = {}, {}
    for q, folds in MESH_FOLDS.items():
        F.LAUNCHES.clear()
        stats = {}
        t0 = time.perf_counter()
        outs[q] = compress_mesh(corpus, mesh=mesh, quality=q, lgwin=22,
                                stats=stats)
        dt = time.perf_counter() - t0
        got = dict(F.LAUNCHES)
        launches.update(got)
        if got != {f: MESH_SHARDS for f in folds}:
            raise AssertionError(f"mesh q{q}: fold launches {got}, want "
                                 f"{MESH_SHARDS} of each of {folds}")
        _report(f"mesh q{q} ({MESH_SHARDS} shards)", corpus, outs[q], dt,
                stats)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            again = compress_mesh(corpus, mesh=mesh, quality=q, lgwin=22)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if again != outs[q]:
            raise AssertionError(f"mesh q{q}: two calls differ")
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        fold_ms = sum(e.time_range.elapsed_us() for e in evs
                      if "fold_kernel" in e.name) / 1e3
        busy_ms = sum(e.time_range.elapsed_us() for e in evs) / 1e3
        log(f"path mesh q{q} traced: wall {wall:.3f} s, fold kernels "
            f"{fold_ms:.4f} ms device ({fold_ms / MESH_SHARDS:.4f} ms a "
            f"shard, {sum(1 for e in evs if 'fold_kernel' in e.name)} "
            f"launches), device busy {busy_ms:.3f} ms, idle share "
            f"{1 - busy_ms / 1e3 / wall:.6f}")
    log(f"path mesh launches: {json.dumps(launches)}")
    _host_profile(f"mesh q{max(MESH_FOLDS)}", lambda: compress_mesh(
        corpus, mesh=mesh, quality=max(MESH_FOLDS), lgwin=22))
    for q, out in outs.items():
        _round_trip(name, decode, out, corpus, f"mesh q{q}")
    log(f"path mesh round trips: ok through {name}")
    return launches


def host_encoder_phase(corpus, card):
    """The host encoder on this machine's CPU: compress at q0, q1, q2,
    q3 and q5 on the corpus and at q9 on its first HOST_Q9_MIB MiB;
    compress_multi with 8 parts at q5 and q9 on the thread, serial
    (whose bytes must equal the thread backend's) and workpool
    backends; compress_batch on HOST_BATCH slices of 64 KiB; and
    compress_mesh on an input under 8 x 4096 bytes, which must equal
    compress on it.  Every output decodes back; prints MB/s (host wall
    clock, one call) and ratio for each under the card line."""
    from brotli_tpu_torch import (compress, compress_batch, compress_mesh,
                                  compress_multi, make_mesh)
    name, decode = _decoder()
    log(f"host encoder phase on {card}")

    def run(what, data, call):
        t0 = time.perf_counter()
        out = call()
        dt = time.perf_counter() - t0
        n_out = sum(map(len, out)) if isinstance(out, list) else len(out)
        log(f"host {what}: {len(data) / dt / 1e6:.2f} MB/s, ratio "
            f"{len(data) / n_out:.4f} ({len(data)} -> {n_out} bytes, "
            f"{dt:.3f} s)")
        return out

    for q in (0, 1, 2, 3, 5):
        out = run(f"compress q{q}", corpus,
                  lambda q=q: compress(corpus, quality=q, lgwin=22))
        _round_trip(name, decode, out, corpus, f"host compress q{q}")
    head = corpus[:HOST_Q9_MIB << 20]
    out = run(f"compress q9 ({HOST_Q9_MIB} MiB)", head,
              lambda: compress(head, quality=9, lgwin=22))
    _round_trip(name, decode, out, head, "host compress q9")
    for q in (5, 9):
        outs = {}
        for backend in ("thread", "serial", "workpool"):
            outs[backend] = run(
                f"compress_multi q{q} 8 parts {backend}", corpus,
                lambda q=q, b=backend: compress_multi(
                    corpus, 8, quality=q, lgwin=22, backend=b))
            _round_trip(name, decode, outs[backend], corpus,
                        f"host compress_multi q{q} {backend}")
        if outs["serial"] != outs["thread"]:
            raise AssertionError(f"compress_multi q{q}: serial and thread "
                                 "backends differ")
    stride = (len(corpus) - (64 << 10)) // (HOST_BATCH - 1)
    slices = [corpus[k * stride:k * stride + (64 << 10)]
              for k in range(HOST_BATCH)]
    total = b"".join(slices)
    outs = run(f"compress_batch q5 {HOST_BATCH} x 64 KiB", total,
               lambda: compress_batch(slices, quality=5, lgwin=22))
    for k, (out, piece) in enumerate(zip(outs, slices)):
        _round_trip(name, decode, out, piece, f"host compress_batch {k}")
    small = corpus[:MESH_SHARDS * 4096 - 1]
    got = compress_mesh(small, mesh=make_mesh(MESH_SHARDS), quality=5,
                        lgwin=22)
    if got != compress(small, quality=5, lgwin=22):
        raise AssertionError("compress_mesh under 8 x 4096 bytes differs "
                             "from compress")
    _round_trip(name, decode, got, small, "host compress_mesh small")
    log(f"host round trips: ok through {name}")


def optimal_parser_phase(corpus, card):
    """The optimal parser (quality 10 and above) and the host decoders on
    this machine's CPU: compress at q11 and q10 on the corpus's first
    HOST_ZOPFLI_MIB MiB; q9_5 at quality 10 on a 1 MiB slice, whose
    single metablock runs the overlapped tier; compress_multi with 8
    parts at q11 on the thread, serial (equal to thread) and workpool
    backends; compress_batch at q11 on ZOPFLI_BATCH slices of 64 KiB.
    Every output decodes back through libbrotlidec and through the
    port's decompress; the pure-Python Decoder decodes a 256 KiB q11
    stream with a custom dictionary and one with a large window.
    Prints MB/s (host wall clock, one call) and ratio for each under the
    card line."""
    from brotli_tpu_torch import (Decoder, compress, compress_batch,
                                  compress_multi, decompress)
    from brotli_tpu_torch.encode import zopfli
    name, decode = _decoder()
    log(f"optimal parser phase on {card}")

    def run(what, data, call):
        t0 = time.perf_counter()
        out = call()
        dt = time.perf_counter() - t0
        n_out = sum(map(len, out)) if isinstance(out, list) else len(out)
        log(f"zopfli {what}: {len(data) / dt / 1e6:.2f} MB/s, ratio "
            f"{len(data) / n_out:.4f} ({len(data)} -> {n_out} bytes, "
            f"{dt:.3f} s)")
        return out

    def round_trip(out, data, what):
        _round_trip(name, decode, out, data, f"zopfli {what}")
        if decompress(out) != data:
            raise AssertionError(f"zopfli {what}: the port's decompress "
                                 "differs")

    head = corpus[:HOST_ZOPFLI_MIB << 20]
    for q in (11, 10):
        out = run(f"compress q{q} ({HOST_ZOPFLI_MIB} MiB)", head,
                  lambda q=q: compress(head, quality=q, lgwin=22))
        round_trip(out, head, f"compress q{q}")
    piece = corpus[1 << 20:2 << 20]
    produced = []
    real = zopfli._zopfli_segment_fast_overlapped

    def overlapped(*args):
        produced.append(real(*args))
        return produced[-1]

    zopfli._zopfli_segment_fast_overlapped = overlapped
    try:
        out = run("compress q10 q9_5 (1 MiB)", piece,
                  lambda: compress(piece, quality=10, q9_5=True, lgwin=22))
    finally:
        zopfli._zopfli_segment_fast_overlapped = real
    if len(produced) != 1 or produced[0] is None:
        raise AssertionError("q9_5 on 1 MiB: the overlapped tier did not "
                             "produce the stream")
    round_trip(out, piece, "compress q10 q9_5")
    outs = {}
    for backend in ("thread", "serial", "workpool"):
        outs[backend] = run(
            f"compress_multi q11 8 parts {backend}", head,
            lambda b=backend: compress_multi(head, 8, quality=11, lgwin=22,
                                             backend=b))
        round_trip(outs[backend], head, f"compress_multi q11 {backend}")
    if outs["serial"] != outs["thread"]:
        raise AssertionError("compress_multi q11: serial and thread "
                             "backends differ")
    stride = (len(corpus) - (64 << 10)) // (ZOPFLI_BATCH - 1)
    slices = [corpus[k * stride:k * stride + (64 << 10)]
              for k in range(ZOPFLI_BATCH)]
    outs = run(f"compress_batch q11 {ZOPFLI_BATCH} x 64 KiB",
               b"".join(slices),
               lambda: compress_batch(slices, quality=11, lgwin=22))
    for k, (out, data) in enumerate(zip(outs, slices)):
        round_trip(out, data, f"compress_batch {k}")
    log(f"zopfli round trips: ok through {name} and decompress")
    data = corpus[2 << 20:(2 << 20) + (256 << 10)]
    dictionary = corpus[:1 << 20]
    for what, enc, dec in (
            ("custom dictionary", dict(custom_dictionary=dictionary),
             Decoder(custom_dictionary=dictionary)),
            ("large window", dict(large_window=True, lgwin=26),
             Decoder(large_window=True))):
        stream = compress(data, quality=11, **enc)
        t0 = time.perf_counter()
        got = dec.decompress(stream)
        dt = time.perf_counter() - t0
        if got != data or decompress(stream, **{
                k: v for k, v in enc.items() if k != "lgwin"}) != data:
            raise AssertionError(f"Decoder, {what}: round trip differs")
        log(f"Decoder q11 {what} (256 KiB): {len(data) / dt / 1e6:.3f} "
            f"MB/s ({dt:.3f} s)")


def streaming_phase(corpus, card):
    """The streaming layer on this machine's CPU: the Compressor at q5
    over the corpus in 64 KiB pieces (its default chunk, flush() every
    STREAM_FLUSH_MIB MiB, one emit_metadata, finish()), at q9 on its
    first STREAM_Q9_MIB MiB and at q11 on its first MiB, each beside
    one-shot compress at the same quality (q5 and q9 within 0.5% of
    it); the pure-Python StreamDecoder on a q5 stream of a 1 MiB slice
    at lgwin 16 fed 4 KiB at a time with max_output 65536, and on a 64
    KiB stream fed one byte at a time, its kept window bounded; the io
    wrappers (CompressorWriter over STREAM_Q9_MIB MiB, a Decompressor
    reading 512 KiB of it back in 4 KiB reads, CompressorReader and
    DecompressorWriter once each); the FFI (an encoder instance over
    STREAM_Q9_MIB MiB through PROCESS, FLUSH, EMIT_METADATA and FINISH
    with TakeOutput in 4 KiB bites, BrotliEncoderCompressPrealloc q5 on
    as much, BrotliDecoderDecompressWithReturnInfo on the q5 stream of
    the corpus, a decoder instance on 512 KiB, a corrupt stream that
    must give BROTLI_DECODER_RESULT_ERROR).  Every stream decodes back
    through libbrotlidec and the port's decompress.  Prints MB/s (host
    wall clock, one call) and ratio for each under the card line."""
    from brotli_tpu_torch import (Compressor, CompressorReader,
                                  CompressorWriter, Decompressor,
                                  DecompressorWriter, StreamDecoder,
                                  compress, decompress, ffi)
    name, decode = _decoder()
    log(f"streaming phase on {card}")

    def round_trip(out, data, what):
        _round_trip(name, decode, out, data, f"streaming {what}")
        if decompress(out) != data:
            raise AssertionError(f"streaming {what}: the port's decompress "
                                 "differs")

    def rate(what, n_in, n_out, dt):
        log(f"streaming {what}: {n_in / dt / 1e6:.2f} MB/s, ratio "
            f"{n_in / n_out:.4f} ({n_in} -> {n_out} bytes, {dt:.3f} s)")

    def stream_compress(data, quality):
        c = Compressor(quality=quality, lgwin=22)
        parts, piece = [], 64 << 10
        flush_every = (STREAM_FLUSH_MIB << 20) // piece
        pieces = range(0, len(data), piece)
        for k, at in enumerate(pieces):
            parts.append(c.process(data[at:at + piece]))
            if (k + 1) % flush_every == 0:
                parts.append(c.flush())
            if k == len(pieces) // 2:
                parts.append(c.emit_metadata(b"chip_smoke streaming"))
        parts.append(c.finish())
        return b"".join(parts), c.chunk_size

    streams = {}
    for q, data in ((5, corpus), (9, corpus[:STREAM_Q9_MIB << 20]),
                    (11, corpus[:1 << 20])):
        t0 = time.perf_counter()
        out, chunk = stream_compress(data, q)
        dt = time.perf_counter() - t0
        rate(f"Compressor q{q} ({len(data) >> 20} MiB, chunk {chunk})",
             len(data), len(out), dt)
        t0 = time.perf_counter()
        one = compress(data, quality=q, lgwin=22)
        dt = time.perf_counter() - t0
        rate(f"compress q{q} one-shot", len(data), len(one), dt)
        excess = len(out) / len(one) - 1
        log(f"streaming q{q}: {excess * 100:+.3f}% against one-shot")
        if q < 10 and excess > 0.005:
            raise AssertionError(f"streaming q{q}: {excess:.4%} larger "
                                 "than one-shot")
        round_trip(out, data, f"Compressor q{q}")
        streams[q] = out

    # the pure-Python decoders read the corpus's first quarter, the
    # repo's text: at a mebibyte a unit of the 32 MiB corpus
    unit = len(corpus) >> 5
    piece = corpus[2 * unit:2 * unit + (1 << 20)]
    comp = compress(piece, quality=5, lgwin=16)
    sd, got, most = StreamDecoder(), [], 0
    t0 = time.perf_counter()
    for at in range(0, len(comp), 4096):
        got.append(sd.decompress(comp[at:at + 4096], max_output=65536))
        most = max(most, len(sd._out._buf))
    while sd.has_more_output or not sd.finished:
        more = sd.decompress(b"", max_output=65536)
        most = max(most, len(sd._out._buf))
        if not more and sd.finished:
            break
        got.append(more)
    got.append(sd.finish())
    dt = time.perf_counter() - t0
    if b"".join(got) != piece or max(map(len, got)) > 65536:
        raise AssertionError("StreamDecoder, 4 KiB pieces: output differs")
    window = (1 << 16) - 16
    if most > window + 2 * 65536:
        raise AssertionError(f"StreamDecoder kept {most} bytes")
    log(f"streaming StreamDecoder q5 lgwin 16 (1 MiB, 4 KiB pieces, "
        f"max_output 65536): {len(piece) / dt / 1e6:.3f} MB/s ({dt:.3f} "
        f"s), {len(got)} calls, at most {most} bytes kept (window "
        f"{window})")
    small = corpus[3 * unit:3 * unit + (64 << 10)]
    comp = compress(small, quality=5, lgwin=22)
    sd, got = StreamDecoder(), bytearray()
    t0 = time.perf_counter()
    for at in range(len(comp)):
        got += sd.decompress(comp[at:at + 1])
    got += sd.finish()
    dt = time.perf_counter() - t0
    if bytes(got) != small:
        raise AssertionError("StreamDecoder, one byte at a time: differs")
    log(f"streaming StreamDecoder one byte at a time (64 KiB, {len(comp)} "
        f"calls): {len(small) / dt / 1e6:.3f} MB/s ({dt:.3f} s), "
        f"{len(sd._out._buf)} bytes kept")

    head = corpus[:STREAM_Q9_MIB << 20]
    sink = io.BytesIO()
    t0 = time.perf_counter()
    w = CompressorWriter(sink)
    for at in range(0, len(head), 64 << 10):
        w.write(head[at:at + (64 << 10)])
    written = w.into_inner().getvalue()
    dt = time.perf_counter() - t0
    rate(f"CompressorWriter q9 ({STREAM_Q9_MIB} MiB)", len(head),
         len(written), dt)
    round_trip(written, head, "CompressorWriter")
    r = Decompressor(io.BytesIO(written))
    t0 = time.perf_counter()
    back = b"".join(r.read(4096) for _ in range(128))
    dt = time.perf_counter() - t0
    if back != head[:512 << 10]:
        raise AssertionError("Decompressor: the first 512 KiB differ")
    log(f"streaming Decompressor 512 KiB in 4 KiB reads: "
        f"{len(back) / dt / 1e6:.3f} MB/s ({dt:.3f} s)")
    t0 = time.perf_counter()
    read = CompressorReader(io.BytesIO(head), quality=5).read()
    dt = time.perf_counter() - t0
    rate(f"CompressorReader q5 ({STREAM_Q9_MIB} MiB)", len(head), len(read),
         dt)
    round_trip(read, head, "CompressorReader")
    part = corpus[4 * unit:4 * unit + (256 << 10)]
    comp = compress(part, quality=9)
    t0 = time.perf_counter()
    dw = DecompressorWriter(io.BytesIO())
    for at in range(0, len(comp), 4096):
        dw.write(comp[at:at + 4096])
    written = dw.into_inner().getvalue()
    dt = time.perf_counter() - t0
    if written != part:
        raise AssertionError("DecompressorWriter: output differs")
    log(f"streaming DecompressorWriter 256 KiB in 4 KiB writes: "
        f"{len(part) / dt / 1e6:.3f} MB/s ({dt:.3f} s)")

    st = ffi.BrotliEncoderCreateInstance()
    if not ffi.BrotliEncoderSetParameter(st, ffi.BROTLI_PARAM_QUALITY, 5):
        raise AssertionError("BrotliEncoderSetParameter failed")
    out = bytearray()
    t0 = time.perf_counter()
    for k, at in enumerate(range(0, len(head), 1 << 20)):
        ops = [(ffi.BROTLI_OPERATION_PROCESS, head[at:at + (1 << 20)])]
        if k == 2:
            ops.append((ffi.BROTLI_OPERATION_FLUSH, b""))
        if k == 4:
            ops.append((ffi.BROTLI_OPERATION_EMIT_METADATA, b""))
        for op, data in ops:
            # the metadata payload is read by EMIT_METADATA alone
            if not ffi.BrotliEncoderCompressStream(
                    st, op, data, metadata=b"ffi metadata"):
                raise AssertionError(f"BrotliEncoderCompressStream op {op} "
                                     "failed")
            while ffi.BrotliEncoderHasMoreOutput(st):
                out += ffi.BrotliEncoderTakeOutput(st, 4096)
    if not ffi.BrotliEncoderCompressStream(st, ffi.BROTLI_OPERATION_FINISH):
        raise AssertionError("BrotliEncoderCompressStream FINISH failed")
    while ffi.BrotliEncoderHasMoreOutput(st):
        out += ffi.BrotliEncoderTakeOutput(st, 4096)
    dt = time.perf_counter() - t0
    if not ffi.BrotliEncoderIsFinished(st):
        raise AssertionError("the FFI encoder did not finish")
    ffi.BrotliEncoderDestroyInstance(st)
    rate(f"FFI encoder instance q5 ({STREAM_Q9_MIB} MiB)", len(head),
         len(out), dt)
    round_trip(bytes(out), head, "FFI encoder instance")
    t0 = time.perf_counter()
    pre = ffi.BrotliEncoderCompressPrealloc(5, 22, 0, head)
    dt = time.perf_counter() - t0
    if pre is None:
        raise AssertionError("BrotliEncoderCompressPrealloc failed")
    rate(f"FFI BrotliEncoderCompressPrealloc q5 ({STREAM_Q9_MIB} MiB)",
         len(head), len(pre), dt)
    round_trip(pre, head, "BrotliEncoderCompressPrealloc")
    buf = bytearray(len(corpus))
    t0 = time.perf_counter()
    info = ffi.BrotliDecoderDecompressWithReturnInfo(streams[5], buf)
    dt = time.perf_counter() - t0
    if info.result != ffi.BROTLI_DECODER_RESULT_SUCCESS or \
            info.decoded_size != len(corpus) or buf != corpus:
        raise AssertionError(f"BrotliDecoderDecompressWithReturnInfo: "
                             f"{info.result} {info.error}")
    log(f"streaming FFI DecompressWithReturnInfo ({len(corpus) >> 20} MiB "
        f"q5 stream): "
        f"{len(corpus) / dt / 1e6:.2f} MB/s ({dt:.3f} s)")
    st = ffi.BrotliDecoderCreateInstance()
    part = corpus[5 * unit:5 * unit + (512 << 10)]
    comp = compress(part, quality=5)
    got, res = bytearray(), None
    t0 = time.perf_counter()
    for at in range(0, len(comp), 4096):
        res = ffi.BrotliDecoderDecompressStream(st, comp[at:at + 4096])
        if res == ffi.BROTLI_DECODER_RESULT_ERROR:
            raise AssertionError(ffi.BrotliDecoderErrorString(st))
        got += ffi.BrotliDecoderTakeOutput(st)
    dt = time.perf_counter() - t0
    if res != ffi.BROTLI_DECODER_RESULT_SUCCESS or \
            not ffi.BrotliDecoderIsFinished(st) or \
            bytes(got) != part:
        raise AssertionError("FFI decoder instance: output differs")
    log(f"streaming FFI decoder instance 512 KiB: "
        f"{len(got) / dt / 1e6:.3f} MB/s ({dt:.3f} s)")
    bad = bytearray(comp)
    bad[40:60] = b"\xff" * 20
    st = ffi.BrotliDecoderCreateInstance()
    res = ffi.BrotliDecoderDecompressStream(st, bytes(bad))
    if res != ffi.BROTLI_DECODER_RESULT_ERROR or \
            ffi.BrotliDecoderGetErrorCode(st) == 0:
        raise AssertionError(f"FFI decoder on a corrupt stream: {res}")
    log(f"streaming FFI corrupt stream: BROTLI_DECODER_RESULT_ERROR "
        f"({ffi.BrotliDecoderErrorString(st)})")
    log(f"streaming round trips: ok through {name} and decompress")


class Refusals:
    """Counts, while installed, the metablocks the port's native stores
    refuse (native_bridge.store_metablock: the pure-Python planner then
    plans the block; native_bridge.encode_metablock: the fused one-shot
    loop then stores it uncompressed, compress_mesh resolves and stores
    it in Python) and the pure-Python planner's calls
    (encode/metablock.build_meta_block), by wrapping the three module
    attributes.  Calls inside the C API's work pool do not pass through
    them and are not counted."""

    def __init__(self):
        import threading
        from brotli_tpu_torch import native_bridge as nb
        from brotli_tpu_torch.encode import metablock as mb
        self._lock = threading.Lock()
        self.reset()

        def counted(mod, name, key, refused_if_none):
            real = getattr(mod, name)

            def call(*a, **k):
                res = real(*a, **k)
                with self._lock:
                    self.counts[key] += 1
                    if refused_if_none and res is None:
                        self.counts[key + "_refused"] += 1
                return res
            setattr(mod, name, call)

        counted(nb, "store_metablock", "store", True)
        counted(nb, "encode_metablock", "encode", True)
        counted(mb, "build_meta_block", "planned", False)

    def reset(self):
        with self._lock:
            self.counts = dict(store=0, store_refused=0, encode=0,
                               encode_refused=0, planned=0)

    def line(self, what: str) -> str:
        c = self.counts
        return (f"{what} refused blocks: store_metablock {c['store_refused']}"
                f" of {c['store']} (planned in Python: {c['planned']}), "
                f"encode_metablock {c['encode_refused']} of {c['encode']}")


def _cli(main, argv, stdin=b""):
    """main(argv) of a CLI in this process, its standard streams swapped
    for in-memory ones: (exit code, stdout bytes, stderr text)."""
    out = io.BytesIO()
    so = io.TextIOWrapper(out, encoding="utf-8")
    se = io.StringIO()
    saved = sys.stdin, sys.stdout, sys.stderr
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin), encoding="utf-8")
    sys.stdout, sys.stderr = so, se
    try:
        rc = main(argv)
        so.flush()
    finally:
        sys.stdin, sys.stdout, sys.stderr = saved
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}: {se.getvalue()[:500]}")
    return rc, out.getvalue(), se.getvalue()


def tools_phase(corpus, card, refusals):
    """The tools on this machine's CPU (no kernel): the port's brotli CLI
    (-c -q9 on the corpus's first TOOLS_MIB MiB file to file in a
    python3 -m subprocess, and back by decompression; -c -q5 -j8
    -validate on the whole corpus; -c -q11 on TOOLS_SMALL_MIB MiB;
    -b3 -c -q5 on TOOLS_MIB MiB; -i, -findprior, -findspeed and
    -advstride on TOOLS_SMALL_MIB MiB), catbrotli (a python3 -m
    subprocess) on four -catable parts of TOOLS_PART_MIB MiB, decoded
    against their join; billing.account on a TOOLS_BILL_KIB KiB q9
    stream, its bits within 7 of 8 x the stream's length; and the route
    of the blocks the native store refuses: compress q5 at lgblock 16
    with the metablock callback (the unfused loop) on TOOLS_REFUSED_MIB
    MiB of low-entropy bytes, the pure-Python planner's calls counted.
    Every stream decodes back through libbrotlidec and the port's
    decompress.  Prints MB/s (host wall clock, one call) and ratio for
    each under the card line."""
    import tempfile

    import numpy as np

    from brotli_tpu_torch import compress, decompress
    from brotli_tpu_torch.cli import brotli_cli
    from brotli_tpu_torch.utils import billing
    name, decode = _decoder()
    log(f"tools phase on {card}")

    def round_trip(out, data, what):
        _round_trip(name, decode, out, data, f"tools {what}")
        if decompress(out) != data:
            raise AssertionError(f"tools {what}: the port's decompress "
                                 "differs")

    def rate(what, n_in, n_out, dt):
        log(f"tools {what}: {n_in / dt / 1e6:.2f} MB/s, ratio "
            f"{n_in / n_out:.4f} ({n_in} -> {n_out} bytes, {dt:.3f} s)")

    def timed(call):
        t0 = time.perf_counter()
        res = call()
        return res, time.perf_counter() - t0

    env = dict(os.environ, PYTHONPATH=ROOT)
    head = corpus[:TOOLS_MIB << 20]
    small = corpus[:TOOLS_SMALL_MIB << 20]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        def path(n):
            return os.path.join(tmp, n)

        for n, data in (("head", head), ("corpus", corpus),
                        ("small", small)):
            with open(path(n), "wb") as f:
                f.write(data)

        def read(n):
            with open(path(n), "rb") as f:
                return f.read()

        _, dt = timed(lambda: subprocess.run(
            [sys.executable, "-m", "brotli_tpu_torch.cli.brotli_cli", "-c",
             "-q9", path("head"), path("head.br")], check=True, env=env,
            cwd=ROOT, timeout=600))
        out = read("head.br")
        rate(f"python3 -m brotli_cli -c -q9 ({TOOLS_MIB} MiB, the "
             "process's start included)", len(head), len(out), dt)
        round_trip(out, head, "brotli_cli -c -q9")
        _, dt = timed(lambda: _cli(brotli_cli.main,
                                   [path("head.br"), path("head.back")]))
        if read("head.back") != head:
            raise AssertionError("brotli_cli decompression differs")
        log(f"tools brotli_cli decompress ({TOOLS_MIB} MiB): "
            f"{len(head) / dt / 1e6:.2f} MB/s ({dt:.3f} s)")
        (_, _, err), dt = timed(lambda: _cli(brotli_cli.main, [
            "-c", "-q5", "-j8", "-validate", path("corpus"),
            path("corpus.br")]))
        if err != "validation OK\n":
            raise AssertionError(f"brotli_cli -j8 -validate: {err!r}")
        out = read("corpus.br")
        rate(f"brotli_cli -c -q5 -j8 -validate ({len(corpus) >> 20} MiB)",
             len(corpus), len(out), dt)
        round_trip(out, corpus, "brotli_cli -j8")
        _, dt = timed(lambda: _cli(brotli_cli.main, [
            "-c", "-q11", path("small"), path("small.br")]))
        out = read("small.br")
        rate(f"brotli_cli -c -q11 ({TOOLS_SMALL_MIB} MiB)", len(small),
             len(out), dt)
        round_trip(out, small, "brotli_cli -q11")
        (_, _, err), dt = timed(lambda: _cli(brotli_cli.main, [
            "-b3", "-c", "-q5", path("head"), path("head5.br")]))
        out = read("head5.br")
        m = re.fullmatch(r"(\d+) bytes in (\d+\.\d{3})s = (\d+\.\d) "
                         r"MB/s\n", err)
        if m is None or int(m.group(1)) != len(head):
            raise AssertionError(f"brotli_cli -b3: {err!r}")
        rate(f"brotli_cli -b3 -c -q5 ({TOOLS_MIB} MiB, 3 calls; its own "
             f"line: {err.strip()})", 3 * len(head), 3 * len(out), dt)
        round_trip(out, head, "brotli_cli -b3")
        (_, ir, _), dt = timed(lambda: _cli(brotli_cli.main,
                                            ["-i", path("small")]))
        lines = ir.decode().splitlines()
        if not lines[0].startswith("prediction lsb6 ") or len(lines) < 100:
            raise AssertionError("brotli_cli -i: no IR dump")
        log(f"tools brotli_cli -i ({TOOLS_SMALL_MIB} MiB): "
            f"{len(small) / dt / 1e6:.2f} MB/s, {len(lines)} records, "
            f"{len(ir)} bytes of text ({dt:.3f} s)")
        for flag in ("-findprior", "-findspeed", "-advstride"):
            (_, _, err), dt = timed(lambda: _cli(brotli_cli.main, [
                flag, "-q5", path("small"), path("flag.br")]))
            out = read("flag.br")
            rate(f"brotli_cli {flag} -q5 ({TOOLS_SMALL_MIB} MiB; "
                 f"{err.splitlines()[0][:120]})", len(small), len(out), dt)
            round_trip(out, small, f"brotli_cli {flag}")

        part = TOOLS_PART_MIB << 20
        parts = []
        for k in range(4):
            with open(path(f"part{k}"), "wb") as f:
                f.write(corpus[k * part:(k + 1) * part])
            _cli(brotli_cli.main, ["-c", "-q5", "-catable", path(f"part{k}"),
                                   path(f"part{k}.br")])
            parts.append(path(f"part{k}.br"))
        _, dt = timed(lambda: subprocess.run(
            [sys.executable, "-m", "brotli_tpu_torch.cli.catbrotli_cli",
             path("joined.br"), *parts], check=True, env=env, cwd=ROOT,
            timeout=600))
        joined = read("joined.br")
        log(f"tools python3 -m catbrotli_cli, four -catable parts of "
            f"{TOOLS_PART_MIB} MiB: {4 * part / dt / 1e6:.2f} MB/s of "
            f"input, {len(joined)} bytes ({dt:.3f} s, the process's start "
            "included)")
        round_trip(joined, corpus[:4 * part], "catbrotli join")

    # billing reads the pure-Python decoder: the repo's text, a quarter
    # of the corpus in
    unit = len(corpus) >> 5
    text = corpus[6 * unit:6 * unit + (TOOLS_BILL_KIB << 10)]
    stream = compress(text, quality=9)
    acc, dt = timed(lambda: billing.account(stream))
    total = sum(acc["bits"].values())
    if acc["output_len"] != len(text) or \
            not 8 * len(stream) - 7 <= total <= 8 * len(stream):
        raise AssertionError(f"billing: {total} bits for {len(stream)} "
                             f"bytes, output {acc['output_len']}")
    top = sorted(acc["bits"].items(), key=lambda kv: -kv[1])[:4]
    log(f"tools billing.account q9 ({TOOLS_BILL_KIB} KiB -> {len(stream)} "
        f"bytes): {len(text) / dt / 1e6:.3f} MB/s ({dt:.3f} s), {total} "
        f"bits, " + ", ".join(f"{k} {v / total:.3f}" for k, v in top))

    low = np.random.default_rng(SEED).integers(
        0, 180, TOOLS_REFUSED_MIB << 20, dtype=np.uint8).tobytes()
    before = dict(refusals.counts)
    out, dt = timed(lambda: compress(low, quality=5, lgblock=16,
                                     metablock_callback=lambda *a: None))
    planned = refusals.counts["planned"] - before["planned"]
    refused = refusals.counts["store_refused"] - before["store_refused"]
    if planned == 0 or planned != refused:
        raise AssertionError(f"refused-block route: {refused} refused, "
                             f"{planned} planned in Python")
    rate(f"compress q5 lgblock 16, low-entropy ({TOOLS_REFUSED_MIB} MiB; "
         f"{refused} blocks refused, {planned} planned in Python)",
         len(low), len(out), dt)
    round_trip(out, low, "refused-block route")
    log(f"tools round trips: ok through {name} and decompress")


def no_runtime_phase(corpus, card, enc, dev):
    """The no-runtime mode in a child process (research/no_runtime.py,
    BROTLI_TPU_TORCH_NO_NATIVE=1): its inputs written to a temporary
    file, its lines printed, its last line read.  Fails if the child
    fails or times out, if a kernel of the three was not launched or if
    a device path was not held to its CPU run."""
    import tempfile

    from brotli_tpu_torch.research import no_runtime as NR
    streams, inputs = serving_batch(corpus, enc, dev, first=NR.LANES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "no_runtime_inputs.pkl")
        NR.write_inputs(path, corpus, streams, inputs)
        env = dict(os.environ, BROTLI_TPU_TORCH_NO_NATIVE="1")
        r = subprocess.run(
            [sys.executable, "-m", "brotli_tpu_torch.research.no_runtime",
             "--inputs", path], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=NO_RUNTIME_TIMEOUT)
    lines = r.stdout.splitlines()
    for ln in lines[:-1]:
        log(ln)
    if r.returncode != 0 or not lines:
        log(r.stdout[-4000:])
        log(r.stderr[-4000:])
        raise AssertionError(f"no-runtime phase: the child exited with "
                             f"{r.returncode}")
    res = json.loads(lines[-1])["no_runtime"]
    for kernel, n in res["launches"].items():
        if n == 0:
            raise AssertionError(f"no-runtime phase: no {kernel} launch")
    if len(res["card_equals_cpu"]) != 6:
        raise AssertionError("no-runtime phase: card == CPU checked on "
                             f"{res['card_equals_cpu']} only")
    log(card)
    log(f"no-runtime phase: child wall {res['wall_s']:.1f} s, launches "
        f"{json.dumps(res['launches'])}")


def cpu_check(corpus, dev):
    from brotli_tpu_torch import compress_fast, compress_gpu, compress_mesh
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
    runs += [(f"mesh q{q} ({MESH_SHARDS} shards)",
              lambda d, q=q: compress_mesh(prefix, n_shards=MESH_SHARDS,
                                           quality=q, lgwin=22, device=d))
             for q in MESH_FOLDS]
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


def _bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def step_probe_phase(dev):
    """TPU probe #9's kernel function at the probe's shape: the latency
    of the instructions on its chain (decode_gpu.latency_probe) and the
    SM clock; the probe's own run (brotli_tpu_torch/research/
    decode_step_kernel_probe.py, launch counts set to 0 just before and
    read just after); then kernel against plain version and timings, with
    the plan launched and each read count's latency bound."""
    import torch

    from brotli_tpu_torch.ops import decode_gpu as D
    from brotli_tpu_torch.research import decode_step_kernel_probe as P
    lat = D.latency_probe(dev)
    khz = D.sm_clock_khz(dev.index or 0)
    log(f"latency probe: dependent cycles {json.dumps(lat)}; SM clock "
        f"{khz} kHz (cudaDevAttrClockRate)")
    tab, st = P.inputs(dev)
    keys = ["step_probe"] + [f"step_probe_reads{r}" for r in D.PROBE_READS]
    for key in keys:
        D.LAUNCHES[key] = 0
    probe = P.run(dev, reps=5, steps=PROBE_STEPS)
    torch.cuda.synchronize()
    launches = {key: D.LAUNCHES[key] for key in keys}
    # per read count a warm call, then twice one call and a chain of 5
    if any(launches[k] != 1 + 2 * (1 + 5) for k in keys[1:]):
        raise AssertionError(f"step_probe: launches {launches} in the "
                             "probe's run")
    log(f"decode_step_kernel_probe: launches {json.dumps(launches)}")
    log(json.dumps({"decode_step_kernel_probe": probe}))
    results = {}
    for reads in D.PROBE_READS:
        got = D.step_probe(tab, st, PROBE_STEPS, reads)
        plan = dict(D.LAST_PROBE_PLAN)
        want = D.step_probe_ref(tab, st, PROBE_STEPS, reads)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"step_probe reads={reads}: kernel != "
                                 "step_probe_ref")
        ms = median_ms(lambda: D.step_probe(tab, st, PROBE_STEPS, reads), 15)
        dt = device_times(lambda: D.step_probe(tab, st, PROBE_STEPS, reads),
                          "step_probe_kernel")
        plain_ms = median_ms(
            lambda: D.step_probe_ref(tab, st, PROBE_STEPS, reads), 3)
        # the table reads and the state in and out; per lane and step an
        # LCG (3 ops), an index add and an accumulate per read, an add
        # and a mask
        bound_ms, by = _bound(
            4 * PROBE_LANES * (PROBE_STEPS * reads + 2),
            PROBE_LANES * PROBE_STEPS * (5 + 2 * reads))
        # a lane's steps are a dependent chain: steps x the cycles of one
        # step's critical path, at the card's SM clock
        cycles = D.step_latency_cycles(reads, lat)
        path = " + ".join(k if n == 1 else f"{n} {k}"
                          for k, n in D.step_latency_path(reads))
        lat_ms = PROBE_STEPS * cycles / (khz * 1e3) * 1e3
        results[reads] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            latency_bound_ms=lat_ms, step_cycles=cycles,
            launches=launches[f"step_probe_reads{reads}"],
            max_abs_err=int((got - want).abs().max()), grid=plan, **dt)
        log(f"kernel step_probe reads={reads}: equal to step_probe_ref at "
            f"{PROBE_LANES} lanes x {PROBE_STEPS} steps; kernel {ms:.4f} ms"
            f" (device {dt['device_ms']:.4f}, burst {dt['burst_ms']:.4f};"
            f" {dt['device_ms'] * 1e3 / PROBE_STEPS:.5f} us a step on "
            f"device time), plain {plain_ms:.3f} ms, bound {bound_ms:.6f} "
            f"ms ({by}), latency bound {lat_ms:.5f} ms ({cycles:.2f} "
            f"cycles a step: {path}; device / latency bound "
            f"{dt['device_ms'] / lat_ms:.3f}); plan {json.dumps(plan)}")
    return results


def radix_phase(dev):
    """The radix probes' own run (both probes' run(), launch counts set
    to 0 just before and read just after), then each primitive against
    its plain version at the probes' shapes: v0 of a 5 MiB corpus as
    int32 [40960, 128], every R of the gathers.  Returns the kernels'
    entries of the kernels line."""
    import numpy as np
    import torch

    from brotli_tpu_torch.ops import radix_cuda as RC
    from brotli_tpu_torch.research import radix_probe as RP
    from brotli_tpu_torch.research import radix_probe2 as RP2
    from brotli_tpu_torch.research.corpus import make_corpus
    data = make_corpus(RADIX_MIB, SEED)
    RC.LAUNCHES.clear()
    t0 = time.perf_counter()
    probe = RP.run(data, dev)
    probe2 = RP2.run(data, dev)
    torch.cuda.synchronize()
    launches = dict(RC.LAUNCHES)
    log(f"radix probes: run in {time.perf_counter() - t0:.1f} s, launches "
        f"{json.dumps(launches)}")
    log(json.dumps({"radix_probe": probe}))
    log(json.dumps({"radix_probe2": probe2}))

    ins = RP.inputs(data, dev)
    x, offs = ins["x"], ins["offs"]
    rows, n = x.shape[0], x.numel()
    # union of the runs' rows: what run_copy must read and write
    covered = np.zeros(rows, bool)
    for o in offs.cpu().tolist():
        covered[o:o + RP.RUN_ROWS] = True
    n_cov = int(covered.sum())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # (name, launch key, replaces, kernel, plain, library call or None,
    #  bytes, integer ops, the kernel's name on the device, its grid)
    sites = []
    for r, where, idx in (
            [(r, "research/radix_probe.py:102", ins["idx"][r])
             for r in RP.GATHER_ROWS]
            + [(r, "research/radix_probe2.py:70",
                RP.block_index(rows, r, r, dev)) for r in RP2.GATHER_ROWS]):
        xv, iv = x.view(-1, r, 128), idx.view(-1, r, 128).long()
        sites.append((f"gather_rows R={r}", f"gather_rows_R{r}", where,
                      lambda r=r, idx=idx: RC.gather_rows(x, idx, r),
                      lambda r=r, idx=idx: RC.gather_rows_ref(x, idx, r),
                      lambda xv=xv, iv=iv: torch.gather(xv, 1, iv),
                      12 * n, 3 * n, "gather_rows_",
                      RC.gather_rows_plan(rows, r)))
    il, il64 = ins["idx_lanes"], ins["idx_lanes"].long()
    sites.append(("gather_lanes", "gather_lanes",
                  "research/radix_probe.py:161",
                  lambda: RC.gather_lanes(x, il),
                  lambda: RC.gather_lanes_ref(x, il),
                  lambda: torch.gather(x, 1, il64), 12 * n, 2 * n,
                  "gather_lanes_kernel", RC.gather_lanes_plan(rows, sms)))
    sites.append(("hist8", "hist8", "research/radix_probe.py:200",
                  lambda: RC.hist8(x), lambda: RC.hist8_ref(x), None,
                  4 * n + 4 * 8 * n // 2048, 2 * n + 32 * 8 * n // 2048,
                  "hist8_kernel", RC.hist8_plan(rows)))
    dst_k, dst_r = torch.zeros_like(x), torch.zeros_like(x)
    sites.append(("run_copy", "run_copy", "research/radix_probe.py:241",
                  lambda: RC.run_copy(x, dst_k, offs, RP.RUN_ROWS),
                  lambda: RC.run_copy_ref(x, dst_r, offs, RP.RUN_ROWS),
                  None, 2 * 512 * n_cov + 4 * len(offs), 0,
                  "run_copy_kernel", None))
    sites.append(("cmpex3", "cmpex3", "research/radix_probe.py:279",
                  lambda: RC.cmpex3(x), lambda: RC.cmpex3_ref(x), None,
                  8 * n, 12 * n, "cmpex3_kernel", None))
    kernels = []
    for name, key, where, kern, plain, lib, nbytes, nops, kname, grid \
            in sites:
        if launches.get(key, 0) == 0:
            raise AssertionError(f"{name}: no launch in the probes' run")
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain version "
                                 f"({int((got != want).sum())} values "
                                 "differ)")
        err = int((got.long() - want.long()).abs().max())
        ms = median_ms(kern, 15)
        dt = device_times(kern, kname)
        plain_ms = median_ms(plain, 15)
        bound_ms, by = _bound(nbytes, nops)
        entry = dict(name=name, route="cuda", source=RP_SRC,
                     replaces=where, launches=launches[key],
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=by, library_ms=None,
                     host_us=host_us(kern), **dt)
        if grid is not None:
            entry["grid"] = grid
        lib_txt = "library none: no single PyTorch call computes it"
        if lib is not None:
            ldt = device_times(lib, "gather")
            entry.update(library_ms=median_ms(lib, 15),
                         library_device_ms=ldt["device_ms"],
                         library_burst_ms=ldt["burst_ms"],
                         library_host_us=host_us(lib))
            lib_txt = (f"torch.gather {entry['library_ms']:.4f} ms (device "
                       f"{ldt['device_ms']:.4f}, burst {ldt['burst_ms']:.4f},"
                       f" host {entry['library_host_us']:.1f} us a call)")
        lib_txt += (f"; wrapper host {entry['host_us']:.1f} us a call"
                    + (f"; grid {json.dumps(grid)}" if grid else ""))
        kernels.append(entry)
        log(f"kernel {name}: equal to its plain version on [{rows}, 128] "
            f"int32; kernel {ms:.4f} ms (device {dt['device_ms']:.4f}, "
            f"burst {dt['burst_ms']:.4f}), plain {plain_ms:.3f} ms, "
            f"{lib_txt}, bound {bound_ms:.5f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB, {nops / 1e6:.1f} M int ops; "
            f"{bound_ms / dt['device_ms']:.3f} of device_ms), "
            f"{launches[key]} launches in the probes' run")
    log(f"radix run_copy: {n_cov} of {rows} rows covered by "
        f"{len(offs)} runs of {RP.RUN_ROWS}")
    return kernels


def _dict_refs(cmds, ncmd) -> int:
    """Commands whose distance reaches past the output so far, counting
    copies at their copy length (exact up to the first dictionary
    reference, so nonzero exactly when the lane has one)."""
    c = cmds[:ncmd].astype("int64")
    ins_before = c[:, 0].cumsum()
    cpy_before = c[:, 1].cumsum() - c[:, 1]
    return int((c[:, 2] > ins_before + cpy_before).sum())


def _decode_compare(lanes, dev, max_steps=None, what=""):
    """decode_step against batch_decode_ref on `lanes` (all seven
    outputs and the step counts).  Returns the kernel's outputs."""
    import torch

    from brotli_tpu_torch.decode import batch_gpu as B
    from brotli_tpu_torch.ops import decode_gpu as D
    args, cap, s_lit, s_cmd = B.lane_arrays(lanes, dev)
    cap = cap if max_steps is None else max_steps
    n = len(lanes)
    ks = torch.zeros(n, dtype=torch.int32, device=dev)
    rs = torch.zeros(n, dtype=torch.int32, device=dev)
    got = D.batch_decode_device(*args, cap, s_lit, s_cmd, steps_out=ks)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    want = D.batch_decode_ref(*args, cap, s_lit, s_cmd, steps_out=rs)
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    for name, g, w in zip(("lits", "nlit", "cmds", "ncmd", "end_bit",
                           "status", "cache", "steps"),
                          list(got) + [ks], list(want) + [rs]):
        if not torch.equal(g, w):
            raise AssertionError(f"decode_step {what}: kernel != "
                                 f"batch_decode_ref in {name} "
                                 f"({int((g != w).sum())} values differ)")
    return got, ks, args, (cap, s_lit, s_cmd), plain_ms


def _decode_timing(got, steps, args, sizes, step_insns, reps=15):
    """decode_step's kernel ms (CUDA events, median of `reps`), its
    device and burst times (device_times), its microseconds a step of
    the longest lane (device time), and its bound on `args`: the stream
    bytes the lanes read and the literals and commands they write,
    against this run's steps times `step_insns`, the fewest a step of
    any build is shown to need (the dict's bound_ms_at_360 counts
    DS_STEP_INSNS)."""
    from brotli_tpu_torch.ops import decode_gpu as D
    ms = median_ms(lambda: D.batch_decode_device(*args, *sizes), reps)
    dt = device_times(lambda: D.batch_decode_device(*args, *sizes),
                      "decode_step_kernel")
    bit0 = args[1].long()
    read = int(((got[4].long() + 7) // 8 - bit0 // 8).sum())
    nlit, ncmd = int(got[1].long().sum()), int(got[3].long().sum())
    nbytes = read + nlit + 12 * ncmd
    nsteps = int(steps.long().sum())
    nops = step_insns * nsteps
    bound_ms, by = _bound(nbytes, nops)
    bound_360 = _bound(nbytes, DS_STEP_INSNS * nsteps)[0]
    per_step_us = dt["device_ms"] * 1e3 / int(steps.max())
    return ms, dict(dt, per_step_us=per_step_us,
                    bound_ms_at_360=bound_360), bound_ms, by, (
        f"{nbytes / 1e6:.2f} MB, {nops / 1e9:.3f} G instructions: "
        f"{step_insns} a step x {nsteps} steps; at {DS_STEP_INSNS} a step "
        f"{bound_360:.4f} ms")


def _plan_text(p: dict) -> str:
    """A decode_step launch's plan (decode_gpu.LAST_PLAN)."""
    return (f"plan 1 lane a warp, {p['lanes_per_cta']} lanes a CTA, "
            f"{p['ctas']} CTAs, {p['smem_bytes']} shared bytes")


def decode_kernel_phase(corpus, dev, enc, step_insns):
    """decode_step against its plain version on 64 lanes of <= 8 KiB from
    every stream source, at the full step cap and at a small one;
    returns the kernel's and the plain version's ms and the bound on
    these lanes (`step_insns` instructions a step)."""
    import numpy as np

    from brotli_tpu_torch import compress_fast, compress_gpu
    from brotli_tpu_torch.ops import decode_gpu as D
    rng = np.random.default_rng(SEED + 3)

    def piece(n, span=DECODE_SPAN):
        off = int(rng.integers(0, span - n))
        return corpus[off:off + n]

    # 8 KiB slices of all three parts; shorter ones of the repo text (a
    # short slice of the records part is stored uncompressed)
    streams = [compress_fast(piece(8192), lgwin=22, quality=1, device=dev)
               for _ in range(24)]
    streams += [enc(piece(8192), 3) for _ in range(24)]
    streams += [enc(piece(int(rng.integers(1024, 8192)), DECODE_SPAN // 3),
                    3) for _ in range(12)]
    streams += [compress_fast(piece(int(rng.integers(1024, 8192)),
                                    DECODE_SPAN // 3),
                              lgwin=22, quality=1, device=dev)
                for _ in range(2)]
    with open(os.path.join(ROOT, "brotli_tpu_torch", "data",
                           "dictionary.bin"), "rb") as f:
        d = f.read()
    dict_at = len(streams)
    streams.append(compress_gpu(d[20000:21000] + d[60000:61000], quality=3,
                                device=dev))
    # flipped bits: the symbol data after the header XORed with seeded
    # random bytes (the header, and so the lane, is unchanged)
    flip_at = len(streams)
    base = enc(piece(8192), 3)
    (lane,) = lanes_of([base])
    cut = lane.bit0 // 8 + 16
    noise = rng.integers(0, 256, len(base) - cut, dtype=np.uint8)
    streams.append(base[:cut] + (np.frombuffer(base[cut:], np.uint8)
                                 ^ noise).tobytes())
    lanes = lanes_of(streams)
    if len(lanes) != 64:
        raise AssertionError(f"decode kernel phase: {len(lanes)} lanes")
    got, steps, args, sizes, plain_ms = _decode_compare(lanes, dev,
                                                        what="64 lanes")
    cap = sizes[0]
    status = got[5].cpu().numpy()
    refs = _dict_refs(got[2][dict_at].cpu().numpy(), int(got[3][dict_at]))
    if status[flip_at] == D.PH_DONE or refs == 0 or \
            (status == D.PH_DONE).sum() != 63:
        raise AssertionError(f"decode kernel phase: statuses {status}, "
                             f"{refs} dictionary references")
    # lanes with codes longer than the kernel's root tables, which take
    # the compare rule past them
    n_long = sum(any(int(max(x)) > b for x, b in zip(
        (ln.lit_len, ln.cmd_len, ln.dist_len), D.LUT_BITS)) for ln in lanes)
    if n_long == 0:
        raise AssertionError("decode kernel phase: no lane has a code "
                             "longer than its root table")
    small = int(steps.float().median()) // 2
    got2, _, _, _, _ = _decode_compare(lanes, dev, max_steps=small,
                                       what=f"max_steps {small}")
    cut_lanes = int((got2[5] < D.PH_DONE).sum())
    if cut_lanes == 0:
        raise AssertionError("decode kernel phase: no lane hit the cap")
    ms, dt, bound_ms, by, work = _decode_timing(got, steps, args, sizes,
                                                step_insns)
    log(f"kernel decode_step: equal to batch_decode_ref in all seven "
        f"outputs on 64 lanes of <= 8 KiB (cap {cap}: 63 done, the "
        f"flipped lane falls back with status {status[flip_at]}, the "
        f"dictionary lane has static-dictionary references, {n_long} lanes "
        f"have codes longer than the root tables {D.LUT_BITS}; steps per "
        f"lane {int(steps.min())}..{int(steps.max())}) and at cap {small} "
        f"({cut_lanes} lanes cut); {_plan_text(D.LAST_PLAN)}; kernel "
        f"{ms:.3f} ms (device {dt['device_ms']:.3f}, burst "
        f"{dt['burst_ms']:.3f}, {dt['per_step_us']:.4f} us a step of the "
        f"longest lane), plain {plain_ms:.1f} ms, bound {bound_ms:.5f} ms "
        f"({by}: {work})")
    return dict(lanes64_ms=ms, lanes64_plain_ms=plain_ms,
                lanes64_bound_ms=bound_ms,
                lanes64_device_ms=dt["device_ms"],
                lanes64_burst_ms=dt["burst_ms"],
                lanes64_per_step_us=dt["per_step_us"])


def decode_path_phase(corpus, dev, enc, step_insns):
    """decompress_batch_gpu on the serving, multi-round and fallback
    batches, then decode_step against its plain version on the serving
    batch's lanes; returns the kernel's and the plain version's ms and
    the bound there (`step_insns` instructions a step), and the
    launches of decode_step on the path."""
    import torch

    from brotli_tpu_torch import decompress_batch_gpu
    from brotli_tpu_torch.decode import batch_gpu as B
    from brotli_tpu_torch.ops import decode_gpu as D

    t0 = time.perf_counter()
    serve, serve_in = serving_batch(corpus, enc, dev)
    multi, multi_in = multi_round_batch(corpus, dev)
    text_span = DECODE_SPAN // 3   # the repo-text part
    stride = (text_span - SERVE_BYTES) // (FALLBACK_STREAMS - 1)
    fall_in = [corpus[k * stride:k * stride + SERVE_BYTES]
               for k in range(FALLBACK_STREAMS)]
    fall = [enc(p, 11) for p in fall_in]
    for s in fall:
        if B._try_parse_stream(s)[0] is not None:
            raise AssertionError("a q11 fallback stream is device-eligible")
    log(f"decode path: streams made in {time.perf_counter() - t0:.1f} s "
        f"(serving {sum(map(len, serve))} bytes, multi-round "
        f"{sum(map(len, multi))}, fallback {sum(map(len, fall))})")

    # the device wrapper, timed with CUDA events (its host work
    # included); the host waits from its launch to the end of the kernel
    run = B.batch_decode_device
    rounds = []

    def timed(*args, **kw):
        n = args[0].shape[0]
        steps = torch.zeros(n, dtype=torch.int32, device=args[0].device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        out = run(*args, steps_out=steps, **kw)
        b.record()
        b.synchronize()
        rounds.append(dict(lanes=n, ms=a.elapsed_time(b),
                           wait_s=time.perf_counter() - t,
                           steps=steps.cpu().numpy(),
                           plan=dict(D.LAST_PLAN), call=(args, kw)))
        return out

    decompress_batch_gpu(serve[:4], device=dev)  # warm: load, first launch
    B.batch_decode_device = timed
    launches = 0
    try:
        for what, streams, inputs, want_dev in (
                ("serving", serve, serve_in, SERVE_STREAMS),
                ("multi-round", multi, multi_in, MULTI_STREAMS),
                ("fallback", fall, fall_in, 0)):
            rounds.clear()
            D.LAUNCHES["decode_step"] = 0
            t = time.perf_counter()
            outs, n_dev = decompress_batch_gpu(streams, device=dev)
            wall = time.perf_counter() - t
            n_launch = D.LAUNCHES["decode_step"]
            if outs != inputs:
                raise AssertionError(f"decode {what}: outputs differ")
            if n_dev != want_dev or n_launch != len(rounds):
                raise AssertionError(f"decode {what}: n_device {n_dev}, "
                                     f"{n_launch} launches in "
                                     f"{len(rounds)} rounds")
            launches += n_launch
            wait = sum(r["wait_s"] for r in rounds)
            # each round's kernel again, for its device time (CUPTI,
            # median of 3, cold L2): per_step_us of the round
            for r in rounds:
                args, kw = r.pop("call")
                r["device_ms"] = device_ms(lambda: run(*args, **kw),
                                           "decode_step_kernel", reps=3)
            per_round = ", ".join(
                f"{r['ms']:.3f} ms on {r['lanes']} lanes, the wrapper's "
                f"host work included (device {r['device_ms']:.3f} ms; "
                f"steps per lane mean {r['steps'].mean():.0f}, max "
                f"{r['steps'].max()}; per_step_us "
                f"{r['device_ms'] * 1e3 / max(int(r['steps'].max()), 1):.4f}"
                f" a step of the longest lane on device time; "
                f"{_plan_text(r['plan'])})"
                for r in rounds) or "no device round"
            log(f"path decode {what}: {sum(map(len, inputs)) / wall / 1e6:.2f}"
                f" MB/s decoded ({len(streams)} streams, "
                f"{sum(map(len, inputs))} bytes, wall {wall:.3f} s), "
                f"n_device {n_dev}, rounds: {per_round}; device-wait share "
                f"{wait / wall:.4f}")
    finally:
        B.batch_decode_device = run
    _host_profile("decode serving",
                  lambda: decompress_batch_gpu(serve, device=dev))

    # the kernel against its plain version on the serving batch's lanes,
    # with the arrays, step cap and buffer sizes the path gave it
    t = time.perf_counter()
    lanes = lanes_of(serve)
    got, steps, args, sizes, plain_ms = _decode_compare(
        lanes, dev, what="serving batch")
    status = got[5].cpu().numpy()
    if (status != D.PH_DONE).any():
        raise AssertionError("decode_step: a serving lane did not finish")
    ms, dt, bound_ms, by, work = _decode_timing(got, steps, args, sizes,
                                                step_insns)
    plan = dict(D.LAST_PLAN)
    log(f"kernel decode_step: equal to batch_decode_ref in all seven "
        f"outputs and the step counts on the serving batch ({len(lanes)} "
        f"lanes, L {args[0].shape[1]}, cap {sizes[0]}, s_lit {sizes[1]}, "
        f"s_cmd {sizes[2]}; steps per lane mean "
        f"{float(steps.float().mean()):.0f} max {int(steps.max())}); "
        f"{_plan_text(plan)}; kernel {ms:.3f} ms (device "
        f"{dt['device_ms']:.3f}, burst {dt['burst_ms']:.3f}, "
        f"{dt['per_step_us']:.4f} us a step of the longest lane), plain "
        f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({by}: {work}; "
        f"{time.perf_counter() - t:.1f} s)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                max_abs_err=0, grid=plan, **dt), launches


def _host_profile(what, call, rows=10):
    """Where one call spends its host time: functions by own time
    (cProfile)."""
    import cProfile
    import pstats

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    call()
    pr.disable()
    log(f"profile {what}: wall {time.perf_counter() - t0:.3f} s "
        "under cProfile; host functions by own time:")
    st = pstats.Stats(pr)
    for (fname, line, func), (_, ncalls, tt, ct, _) in sorted(
            st.stats.items(), key=lambda kv: -kv[1][2])[:rows]:
        where = os.path.relpath(fname, ROOT) if fname.startswith(ROOT) \
            else fname
        log(f"  {tt:8.3f} s own {ct:8.3f} s cum {ncalls:6d} calls  "
            f"{where}:{line}({func})")


def decode_cpu_check(corpus, dev, enc):
    from brotli_tpu_torch import compress_fast, decompress_batch_gpu
    stride = (DECODE_SPAN - 4096) // 31
    pieces = [corpus[k * stride:k * stride + 4096] for k in range(32)]
    streams = [compress_fast(p, lgwin=22, quality=1, device=dev)
               if k % 2 == 0 else enc(p, 3) for k, p in enumerate(pieces)]
    t0 = time.perf_counter()
    a, b = decompress_batch_gpu(streams, device=dev), \
        decompress_batch_gpu(streams, device="cpu")
    if a != b or a[0] != pieces or a[1] != 32:
        raise AssertionError("decompress_batch_gpu: card and CPU differ")
    log(f"cpu check decompress_batch_gpu: card == cpu on 32 streams of "
        f"4 KiB, n_device {a[1]} ({time.perf_counter() - t0:.1f} s)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "brotli_tpu_torch")):
        print("chip_smoke: brotli_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    from brotli_tpu_torch.research.corpus import make_corpus
    card = card_line()
    log(card)
    import numpy
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, numpy {numpy.__version__}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    ds_lib, fold_lib, dp_lib = build_all()
    from brotli_tpu_torch import native_bridge as nb
    if not nb.available() or nb._lib is None:
        raise AssertionError("the native runtime did not build or load")
    fold_ptxas = resource_usage(fold_lib)
    log(f"build wall: {time.perf_counter() - t0:.1f} s")
    floor, n_insns = sass_step_floor(ds_lib)
    step_insns = min(floor, DS_STEP_INSNS)
    log(f"sass decode_step_kernel: {n_insns} instructions; one trip of the "
        f"step loop executes at least {floor} (the bound counts "
        f"{step_insns} a step, the fewer of this and {DS_STEP_INSNS})")
    corpus = make_corpus(CORPUS_MIB, SEED)
    log(f"corpus: {len(corpus)} bytes, seed {SEED}")

    enc = native_encoder()

    t0 = time.perf_counter()
    timings = kernel_phase(corpus, dev, fold_ptxas, ROW_CONFIGS, ROW)
    timings.update(kernel_phase(corpus, dev, fold_ptxas, MESH_CONFIGS,
                                MESH_ROW))
    mr_timings = match_rounds_phase(corpus, dev)
    sp_timings = step_probe_phase(dev)
    ds_lanes64 = decode_kernel_phase(corpus, dev, enc, step_insns)
    dp_timings = dict_probe_phase(corpus, dev, resource_usage(dp_lib))
    log(f"kernel phase wall: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mirror_phase(corpus, dev, card)
    log(f"mirror phase wall: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = path_phase(corpus, dev)
    log(f"path phase wall: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["mesh"] = mesh_phase(corpus, dev)
    log(f"mesh phase wall: {time.perf_counter() - t0:.1f} s")
    refusals = Refusals()
    t0 = time.perf_counter()
    host_encoder_phase(corpus, card)
    log(f"host encoder phase wall: {time.perf_counter() - t0:.1f} s")
    log(refusals.line("host encoder phase"))
    t0 = time.perf_counter()
    ds_serving, ds_launches = decode_path_phase(corpus, dev, enc,
                                                step_insns)
    log(f"decode path phase wall: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    optimal_parser_phase(corpus, card)
    log(f"optimal parser phase wall: {time.perf_counter() - t0:.1f} s")
    refusals.reset()
    t0 = time.perf_counter()
    streaming_phase(corpus, card)
    log(f"streaming phase wall: {time.perf_counter() - t0:.1f} s")
    log(refusals.line("streaming phase"))
    refusals.reset()
    t0 = time.perf_counter()
    tools_phase(corpus, card, refusals)
    log(f"tools phase wall: {time.perf_counter() - t0:.1f} s")
    log(refusals.line("tools phase"))
    t0 = time.perf_counter()
    no_runtime_phase(corpus, card, enc, dev)
    log(f"no-runtime phase wall: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cpu_check(corpus, dev)
    decode_cpu_check(corpus, dev, enc)
    log(f"cpu check wall: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    radix_kernels = radix_phase(dev)
    log(f"radix phase wall: {time.perf_counter() - t0:.1f} s")
    profile_phase(corpus, dev)

    from brotli_tpu_torch.ops.fold_cuda import config_name
    kernels = []
    for label, n_keys, n_pay, k_fwd, k_back, fuse, path in \
            ROW_CONFIGS + MESH_CONFIGS:
        if path is None:
            continue
        n = launches[path].get(
            config_name(n_keys, n_pay, k_fwd, k_back, fuse), 0)
        if n == 0:
            raise AssertionError(f"{label}: no launch on its path")
        kernels.append(dict(name=label, route="cuda", source=SRC,
                            replaces=REPLACES, launches=n,
                            library_ms=None, **timings[label]))
    # the fold form on compress_fast, by its offsets; the two-operand
    # form is on no path (its launches are 0)
    for name, key, t in mr_timings:
        n = launches["fast"].get(key, 0)
        if n == 0 and name != "match_rounds":
            raise AssertionError(f"{name}: no launch on its path")
        kernels.append(dict(name=name, route="cuda", source=MR_SRC,
                            replaces=MR_REPLACES, launches=n,
                            library_ms=None, **t))
    if ds_launches == 0:
        raise AssertionError("decode_step: no launch on its path")
    kernels.append(dict(name="decode_step", route="cuda", source=DS_SRC,
                        replaces=DS_REPLACES, launches=ds_launches,
                        library_ms=None, sass_step_floor=floor,
                        **ds_serving, **ds_lanes64))
    for reads, t in sp_timings.items():
        kernels.append(dict(name=f"step_probe reads={reads}", route="cuda",
                            source=DS_SRC, replaces=SP_REPLACES,
                            library_ms=None, **t))
    for name, t in dp_timings.items():
        kernels.append(dict(name=f"dict_probe {name}", route="cuda",
                            source=DP_SRC, replaces=DP_REPLACES,
                            launches=launches["dict_probe"]["q5"],
                            launches_by_quality=launches["dict_probe"],
                            library_ms=None, **t))
    kernels += radix_kernels
    for k in kernels:
        k["device_bound_share"] = k["bound_ms"] / k["device_ms"]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
