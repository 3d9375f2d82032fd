"""How often a symbol's code is longer than a root table of R bits.

    python -m brotli_tpu_torch.research.root_bits [--every 16] [--device cpu]

On every `--every`-th pair of streams of the serving batch
(decode_batches.py: one through compress_fast, one native),
for the literal, command and distance trees of each device lane and R =
6 ... 11: the share of symbols whose code is longer than R, taken as
the sum of 2**-length over those codes (a Huffman code's lengths stand
for its symbols' frequencies). The mean and the largest share over the
lanes say what ops/decode_gpu.py:LUT_BITS trades: a longer table costs
shared memory and staging, a shorter one the compare rule more often.
Runs on the CPU by default (compress_fast's plain path); prints one
JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .corpus import SEED, make_corpus
from .decode_batches import (DECODE_SPAN, SERVE_BYTES, SERVE_STREAMS,
                             lanes_of, native_encoder)

TREES = ("lit_len", "cmd_len", "dist_len")
BITS = range(6, 12)


def long_share(lengths, bits: int) -> float:
    """Sum of 2**-length over the codes longer than `bits` (0 for a
    one-symbol tree, whose symbol takes no bits)."""
    ln = np.asarray(lengths, np.int64)
    ln = ln[ln > 0]
    return float(np.sum(2.0 ** -ln[ln > bits])) if len(ln) > 1 else 0.0


def run(every: int, device: str) -> dict:
    from .. import compress_fast
    corpus = make_corpus(32, SEED)
    enc = native_encoder()
    stride = (DECODE_SPAN - SERVE_BYTES) // (SERVE_STREAMS - 1)
    streams = []
    for k in range(0, SERVE_STREAMS, every):
        for j in (k, k + 1):   # one stream of each encoder
            p = corpus[j * stride:j * stride + SERVE_BYTES]
            streams.append(compress_fast(p, lgwin=22, quality=1,
                                         device=device)
                           if j % 2 == 0 else enc(p, 3))
    lanes = lanes_of(streams)
    out = {"lanes": len(lanes)}
    for tree in TREES:
        for b in BITS:
            s = np.array([long_share(getattr(ln, tree), b) for ln in lanes])
            out[f"{tree} R={b}"] = dict(mean=float(s.mean()),
                                        max=float(s.max()))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--every", type=int, default=16,
                    help="take every n-th pair of serving streams")
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args(argv)
    print(json.dumps({"root_bits": run(a.every, a.device)}), flush=True)


if __name__ == "__main__":
    main()
