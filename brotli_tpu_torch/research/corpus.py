"""The seeded corpus that chip_smoke.py and the probes run on.

`make_corpus(mib, seed)` gives exactly `mib` MiB, the same bytes at
every commit of the port for the same arguments: 1/4 text files of the
repo that the port leaves unchanged (read relative to the repo root),
1/4 zipf-distributed words, 1/4 64-byte records with 1/16 noise, 1/8
slowly varying int32, 1/8 random bytes.
"""

from __future__ import annotations

import glob
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CORPUS_DOCS = ["PAPER.md", "PAPERS.md", "SNIPPETS.md", "SURVEY.md"]
SEED = 20261016


def make_corpus(mib: int, seed: int) -> bytes:
    """`mib` MiB from the seed: 1/4 repo text, 1/4 zipf words, 1/4
    records with noise, 1/8 slowly varying int32, 1/8 random bytes."""
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
        raise RuntimeError("make_corpus: the repo's text files are missing")
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
        raise RuntimeError(f"make_corpus: corpus is {len(corpus)} bytes")
    return corpus
