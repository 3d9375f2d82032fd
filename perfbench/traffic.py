"""The one traffic generator: reads a mix's parameters (traffic/*.json)
and makes the pool, the order of requests and their arrivals from the
seed.  A request kind (kinds/<name>.py) takes the pool of its kind.

Every mix may name its arrival process:
  arrivals  {"process": "closed"} (the default): one client sends the
           next request when the last has returned
           {"process": "poisson", "rate_per_s": R, "block": B}: requests
           arrive at the rate R, whatever the system does; the gaps
           between arrivals are, in every block of B (default 64), the
           B quantiles (i + 0.5) / B of the exponential distribution of
           mean 1 / R in a seeded order, so every seed offers the same
           load; one server takes them first come, first served

kind "files" (one file a request, for a compress entry):
  sizes    {"dist": "fixed", "bytes": B, "count": N} or
           {"dist": "log_uniform", "min": A, "max": B, "count": N}: the
           N sizes are fixed (the log-uniform quantiles (i + 0.5) / N),
           only their content and order come from the seed
  mix      the parts of each file (corpus.py)
  strata   the sorted sizes fall into this many strata; requests come in
           rounds of one file of every stratum, each round in a seeded
           order, so every stretch of the window holds the same sizes
  warm_requests  set-up's requests beyond one file of each size class
           (power of two), drawn from the pool by a stream of the seed
           of their own: they let the program's allocators settle
kind "streams" (a batch of streams a request, for a decode entry):
  corpus   {"bytes", "mix"}: the plaintext the objects are sliced from
  streams  {"count", "bytes", "encoders"}: `count` objects of `bytes` at
           staggered offsets of the corpus, object k made by encoder
           k % len(encoders) (the config's `encoders`)
  request_streams  objects a request: a seeded draw without repeats,
           as many from each encoder
  check_every  the outputs of one request in this many are kept and
           compared whole (a seeded offset); every output's length is
           compared
  warm_requests  set-up's requests (at least one), from a stream of the
           seed of their own
"""

from __future__ import annotations

import hashlib

import numpy as np

from corpus import make_files, seed_seq


def arrivals(traffic: dict, seed: int):
    """Arrival times (s after the window opens), without end, or None for
    a closed loop."""
    spec = traffic.get("arrivals", {"process": "closed"})
    if spec["process"] == "closed":
        return None
    if spec["process"] != "poisson":
        raise ValueError(f"traffic: unknown arrival process "
                         f"{spec['process']!r}")
    rate, block = float(spec["rate_per_s"]), int(spec.get("block", 64))
    gaps = -np.log1p(-(np.arange(block) + 0.5) / block) / rate
    rng = np.random.default_rng(seed_seq(seed, 4))

    def times():
        t = 0.0
        while True:
            for g in gaps[rng.permutation(block)]:
                t += float(g)
                yield t
    return times()


class Files:
    """A pool of files and the order in which requests take them."""

    def __init__(self, traffic: dict, seed: int):
        sz = traffic["sizes"]
        n = int(sz["count"])
        if sz["dist"] == "fixed":
            sizes = [int(sz["bytes"])] * n
        elif sz["dist"] == "log_uniform":
            lo, hi = float(sz["min"]), float(sz["max"])
            sizes = [int(round(lo * (hi / lo) ** ((i + 0.5) / n)))
                     for i in range(n)]
        else:
            raise ValueError(f"traffic: unknown size dist {sz['dist']!r}")
        self.sizes = sorted(sizes)
        self.pool = make_files(self.sizes, seed, traffic["mix"])
        self.strata = int(traffic.get("strata", 1))
        if n % self.strata:
            raise ValueError("traffic: count is not a multiple of strata")
        self.rng = np.random.default_rng(seed_seq(seed, 2))
        self.warm_requests = int(traffic.get("warm_requests", 0))
        self.warm_rng = np.random.default_rng(seed_seq(seed, 3))

    def sha256(self) -> str:
        h = hashlib.sha256()
        for f in self.pool:
            h.update(f)
        return h.hexdigest()

    def order(self):
        """Pool indices, one a request, without end."""
        per = len(self.pool) // self.strata
        while True:
            within = [self.rng.permutation(per) for _ in range(self.strata)]
            for r in range(per):
                for s in self.rng.permutation(self.strata):
                    yield int(s * per + within[s][r])

    def warm(self) -> list:
        """Set-up's pool indices: the smallest file of every size class
        (power of two), then `warm_requests` seeded draws."""
        seen, out = set(), []
        for i, s in enumerate(self.sizes):
            c = (s - 1).bit_length()
            if c not in seen:
                seen.add(c)
                out.append(i)
        return out + [int(i) for i in self.warm_rng.integers(
            0, len(self.pool), size=self.warm_requests)]


class Streams:
    """A pool of compressed objects and the batches requests take."""

    def __init__(self, traffic: dict, seed: int, encoders: dict):
        cp = traffic["corpus"]
        self.corpus = make_files([int(cp["bytes"])], seed, cp["mix"])[0]
        st = traffic["streams"]
        count, size = int(st["count"]), int(st["bytes"])
        span = len(self.corpus)
        stride = (span - size) // (count - 1) if count > 1 else 0
        self.plain = [self.corpus[k * stride:k * stride + size]
                      for k in range(count)]
        names = st["encoders"]
        self.groups = [list(range(e, count, len(names)))
                       for e in range(len(names))]
        self.streams = [encoders[names[k % len(names)]](p)
                        for k, p in enumerate(self.plain)]
        self.per_request = int(traffic["request_streams"])
        if self.per_request % len(names) or any(
                len(g) < self.per_request // len(names)
                for g in self.groups):
            raise ValueError("traffic: request_streams does not split "
                             "evenly over the encoders' objects")
        self.check_every = int(traffic.get("check_every", 1))
        self.rng = np.random.default_rng(seed_seq(seed, 2))
        self.check_offset = int(self.rng.integers(0, self.check_every))
        self.warm_rng = np.random.default_rng(seed_seq(seed, 3))
        self.warm_requests = max(int(traffic.get("warm_requests", 1)), 1)

    def sha256(self) -> tuple:
        """(plaintext corpus, stream pool) sha256."""
        h = hashlib.sha256()
        for s in self.streams:
            h.update(len(s).to_bytes(8, "little"))
            h.update(s)
        return hashlib.sha256(self.corpus).hexdigest(), h.hexdigest()

    def _draw(self, rng) -> list:
        each = self.per_request // len(self.groups)
        pick = np.concatenate([rng.choice(g, size=each, replace=False)
                               for g in self.groups])
        return [int(i) for i in rng.permutation(pick)]

    def order(self):
        """Lists of object indices, one a request, without end."""
        while True:
            yield self._draw(self.rng)

    def warm(self) -> list:
        """Set-up's requests: batches from a stream of the seed of their
        own, so the window's requests do not depend on them."""
        return [self._draw(self.warm_rng)
                for _ in range(self.warm_requests)]

    def checked(self, r: int) -> bool:
        """Whether request r's outputs are kept and compared whole."""
        return (r + self.check_offset) % self.check_every == 0
