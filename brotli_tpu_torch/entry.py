"""Entry points: the single-device step and the multi-shard dry run.

Counterparts of __graft_entry__.py's entry() and dryrun_multichip(n).

entry() returns the flagship forward step and its arguments: the
device match + parse pipeline (content sort, the fold kernel, capped
match lengths, scoring, the pointer-doubling committed parse) on one
256 KiB block, as a plain function on tensors.

dryrun_multichip(n) runs compress_mesh end to end over n shards at
q9 / lgwin 16 (halo matching per shard, host serialization, BroCatli
merge) and checks the round trip through the port's decoder (the
native one, or the Python one where the runtime is not in use).
Both run on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from .decode.decoder import decompress
from .device import resolve_device
from .ops.fold_cuda import best_matches_exact_p
from .ops.parse import committed_parse
from .parallel.mesh import compress_mesh, make_mesh

BLOCK = 1 << 18
WINDOW = BLOCK - 16


def _step(data: torch.Tensor):
    """(visited, take, best_dist) of one block: the fold (k = 32, rounds
    = 2), then the committed parse over 4096-byte sub-blocks."""
    packed = best_matches_exact_p(data, WINDOW, k=32, rounds=2)
    best_len = packed >> 26
    best_dist = packed & ((1 << 26) - 1)
    visited, take = committed_parse(best_len, 135 * best_len, 4096)
    return visited, take, best_dist


def entry_block() -> np.ndarray:
    """The 256 KiB block entry() runs on: a repeated phrase with 20% of
    its bytes replaced by seeded noise."""
    rng = np.random.default_rng(0)
    text = b"the quick brown fox jumps over the lazy dog. " * 8192
    noise = rng.integers(0, 256, len(text), dtype=np.uint8)
    mask = rng.random(len(text)) < 0.2
    return np.where(mask, noise,
                    np.frombuffer(text, np.uint8)).astype(np.uint8)[:BLOCK]


def entry(device=None):
    """(step, args): step(*args) is the forward step on the block of
    entry_block(), on `device` (None = the current CUDA card)."""
    dev = resolve_device(device)
    return _step, (torch.from_numpy(entry_block()).to(dev),)


def dryrun_data() -> bytes:
    """The dry run's 184,320 bytes: a repeated phrase with 15% of its
    bytes replaced by seeded noise."""
    rng = np.random.default_rng(1)
    text = b"the quick brown fox jumps over the lazy dog. " * 4096
    noise = rng.integers(0, 256, len(text), dtype=np.uint8)
    mask = rng.random(len(text)) < 0.15
    return np.where(mask, noise,
                    np.frombuffer(text, np.uint8)).astype(np.uint8).tobytes()


def dryrun_multichip(n_devices: int, device=None) -> bytes:
    """compress_mesh over n_devices shards of dryrun_data() at q9 and a
    small window (lgwin 16, so each shard's halo covers the whole
    window); raises unless the stream decodes back through the port's
    decompress.  Returns the stream."""
    data = dryrun_data()
    out = compress_mesh(data, mesh=make_mesh(n_devices, device), quality=9,
                        lgwin=16)
    if decompress(out) != data:
        raise RuntimeError("dryrun_multichip: the mesh stream does not "
                           "decode back")
    return out
