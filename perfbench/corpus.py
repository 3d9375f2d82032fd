"""The benchmark's seeded data: files with the mix of the port's corpus.

A frozen, generalised copy of `brotli_tpu_torch/research/corpus.py`
(`make_corpus`), so that no later edit of the program or of a document
moves the yardstick.  Its five parts are made as that function makes
them:

  source   lines of data/source.txt (text of the repo, frozen here),
           the whole text from a seeded line on, then seeded lines
  zipf     words of 2-9 letters from a 3,000-word vocabulary, zipf(1.2)
  records  64 distinct 64-byte records, tiled, shuffled, 1/16 of the
           bytes replaced by noise
  ints     slowly varying little-endian int32 (steps of -3..3)
  random   uniform bytes

The vocabulary and the 64 records are the mix's language and are the
same for every seed (drawn from LANGUAGE_SEED, the port's corpus seed):
which words and records follow each other, the noise, the text's lines,
the integers and the random bytes come from the seed.  A random
vocabulary a seed made the work itself change from seed to seed (word
lengths and the static dictionary's hits), not only its order.

`make_files(sizes, seed, mix)` makes one file per size.  File k holds,
in that order, its share of each part by `mix`; each part is made once
for all files from its own stream of the seed and cut into the files'
shares, so every file has its own bytes and a pool of any size costs
one pass.  The bytes depend on numpy's generator: numpy 2.3 and 2.0
give different bytes for one seed (`sha256` of the inputs is printed
on every run).
"""

from __future__ import annotations

import os

import numpy as np

PARTS = ("source", "zipf", "records", "ints", "random")
LANGUAGE_SEED = 20261016
TEXT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "source.txt")


def seed_seq(seed: int, *keys: int) -> np.random.SeedSequence:
    """A SeedSequence for any whole number `seed` (negative or past 64
    bits included) and the stream keys."""
    return np.random.SeedSequence([seed % (1 << 64), *keys])


def _source(n: int, rng) -> bytes:
    with open(TEXT, "rb") as f:
        text = f.read()
    lines = text.splitlines(keepends=True)
    first = int(rng.integers(0, len(lines)))
    out = b"".join(lines[first:] + lines[:first])
    while len(out) < n:
        pick = rng.integers(0, len(lines), size=(n - len(out)) // 16 + 16)
        out += b"".join(lines[i] for i in pick)
    return out[:n]


def _language():
    """The vocabulary and the 64 records, the same for every seed."""
    rng = np.random.default_rng(LANGUAGE_SEED)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 10),
                                dtype=np.uint8)) for _ in range(3000)]
    return words, rng.integers(0, 256, size=(64, 64), dtype=np.uint8)


def _zipf(n: int, rng) -> bytes:
    words = _language()[0]
    out = b""
    while len(out) < n:
        zipf = rng.zipf(1.2, size=(n - len(out)) // 3 + 16) % len(words)
        out += b" ".join(words[i] for i in zipf) + b" "
    return out[:n]


def _records(n: int, rng) -> bytes:
    recs = np.tile(_language()[1], (n // 4096 + 1, 1))
    recs = recs[rng.permutation(len(recs))].ravel()[:n]
    noise = rng.integers(0, len(recs), size=len(recs) // 16)
    recs[noise] = rng.integers(0, 256, size=len(noise), dtype=np.uint8)
    return recs.tobytes()


def _ints(n: int, rng) -> bytes:
    ints = np.cumsum(rng.integers(-3, 4, size=n // 4 + 1)).astype("<i4")
    return ints.tobytes()[:n]


def _random(n: int, rng) -> bytes:
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


_MAKERS = {"source": _source, "zipf": _zipf, "records": _records,
           "ints": _ints, "random": _random}


def shares(size: int, mix: dict) -> list:
    """The bytes of each part in a file of `size` bytes: the parts in
    PARTS order, each floor(size * fraction), the last present part
    taking the remainder."""
    present = [p for p in PARTS if mix.get(p, 0) > 0]
    unknown = set(mix) - set(PARTS)
    if unknown or not present:
        raise ValueError(f"mix: unknown parts {sorted(unknown)} or none "
                         f"present in {mix}")
    total = sum(mix[p] for p in present)
    out = {p: int(size * mix[p] / total) for p in present}
    out[present[-1]] += size - sum(out.values())
    return [out.get(p, 0) for p in PARTS]


def make_files(sizes, seed: int, mix: dict) -> list:
    """One file of bytes per size in `sizes`, from `seed`, each with the
    mix of parts `mix` (fractions by part name)."""
    per_file = [shares(int(s), mix) for s in sizes]
    parts = []
    for t, name in enumerate(PARTS):
        need = sum(f[t] for f in per_file)
        rng = np.random.default_rng(seed_seq(seed, 1, t))
        parts.append(_MAKERS[name](need, rng) if need else b"")
    files, offs = [], [0] * len(PARTS)
    for f in per_file:
        chunks = []
        for t, n in enumerate(f):
            chunks.append(parts[t][offs[t]:offs[t] + n])
            offs[t] += n
        files.append(b"".join(chunks))
    return files
