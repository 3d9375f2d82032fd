"""Request kind "decode_batch": a list of streams in, (outputs,
n_device) out.

The pool is a mix of kind "streams" (traffic.Streams), whose objects
the configuration's `encoders` make at set-up.  An encoder is either
  {"lib": "brotlienc", "quality", "lgwin", "mode"}: google/brotli's own
      encoder from the machine's system libraries (BrotliEncoderCompress),
      independent of the program, or
  {"entry": "module:attr", "kwargs"}: an encoder of the program.
The check compares the outputs of the requests traffic.Streams.checked
picks whole with the plaintext the benchmark made, and every output's
length.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import importlib

import numpy as np

import faults
import reference
from traffic import Streams


def system_encoder(lib: str, quality: int, lgwin: int, mode: int):
    """BrotliEncoderCompress of the system library `lib` as enc(data)
    -> bytes."""
    path = ctypes.util.find_library(lib)
    if path is None:
        raise RuntimeError(f"encoder: lib{lib} not found")
    fn = ctypes.CDLL(path).BrotliEncoderCompress
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
                   ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
                   ctypes.c_char_p]

    def enc(data: bytes) -> bytes:
        cap = len(data) + (len(data) >> 2) + 1024
        out = ctypes.create_string_buffer(cap)
        size = ctypes.c_size_t(cap)
        if fn(quality, lgwin, mode, len(data), data, ctypes.byref(size),
              out) != 1:
            raise RuntimeError(f"lib{lib} q{quality} failed")
        return out.raw[:size.value]
    return enc


def program_encoder(entry: str, kwargs: dict, device):
    mod_name, _, attr = entry.partition(":")
    fn = getattr(importlib.import_module(mod_name), attr)
    kw = dict(kwargs)
    if device is not None:
        kw["device"] = device
    return lambda p: fn(p, **kw)


def encoders_of(config: dict, device) -> dict:
    out = {}
    for name, spec in config.get("encoders", {}).items():
        if "lib" in spec:
            out[name] = system_encoder(spec["lib"], spec["quality"],
                                       spec["lgwin"], spec["mode"])
        else:
            out[name] = program_encoder(spec["entry"],
                                        spec.get("kwargs", {}), device)
    return out


class Requests:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.pool = Streams(traffic, seed, encoders_of(config, device))
        self.kept, self.lengths = [], []

    def describe(self) -> str:
        plain_sha, stream_sha = self.pool.sha256()
        return (f"inputs sha256 {plain_sha} (corpus, "
                f"{len(self.pool.corpus)} bytes, numpy {np.__version__}); "
                f"stream pool sha256 {stream_sha} ({len(self.pool.streams)} "
                f"streams, {sum(map(len, self.pool.streams))} bytes)")

    def warm(self) -> list:
        return self.pool.warm()

    def order(self):
        return self.pool.order()

    def payload(self, x):
        return [self.pool.streams[i] for i in x]

    def size_in(self, payload) -> int:
        return sum(map(len, payload))

    def answered(self, r: int, x, payload, answer) -> int:
        outs, n_dev = answer
        self.lengths.append((x, [len(o) for o in outs], n_dev))
        if self.pool.checked(r):
            self.kept.append((x, outs))
        return sum(map(len, outs))

    def check(self, n_requests: int, failed: int):
        plain = self.pool.plain
        bad_len = sum(1 for x, lens, _ in self.lengths
                      for i, n in zip(x, lens) if n != len(plain[i]))
        bad = reference.bad_outputs(
            (o, plain[i]) for x, outs in self.kept for i, o in zip(x, outs))
        n_dev = sum(n for _, _, n in self.lengths)
        n_all = sum(len(x) for x, _, _ in self.lengths)
        checks = {"bad_outputs": (bad, "at_most", 0),
                  "bad_lengths": (bad_len, "at_most", 0),
                  "failed_requests": (failed, "at_most", 0),
                  "checked_requests": (len(self.kept), "at_least", 1)}
        return checks, (
            f"compared {sum(len(x) for x, _ in self.kept)} outputs of "
            f"{len(self.kept)} of {n_requests} requests whole, every "
            f"output's length; n_device {n_dev} of {n_all} streams")

    def broken(self, call, fault: str, seed: int):
        """`call` with a fault planted (faults.FAULTS):
          control    one seeded byte of one seeded output a request
                     changed (a decoder off by a byte)
          alter      a byte of each output altered where it is produced
          unchanged  the streams handed back as the outputs
          half       the second half of the batch's outputs left empty"""
        if fault not in faults.FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        rng = faults.rng(seed)

        def decode(streams):
            outs, n_dev = call(streams)
            outs = list(outs)
            if fault == "control":
                k = int(rng.integers(len(outs)))
                outs[k] = faults.flip(outs[k], int(rng.integers(1 << 30)))
            elif fault == "alter":
                outs = [faults.flip(o, len(o) // 2 + 7) for o in outs]
            elif fault == "unchanged":
                outs = [bytes(s) for s in streams]
            else:
                outs[len(outs) // 2:] = [b""] * (len(outs) - len(outs) // 2)
            return outs, n_dev
        return decode
