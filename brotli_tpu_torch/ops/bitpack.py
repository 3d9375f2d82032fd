"""Bit packing on a device: (bits, nbits) items -> packed little-endian
u32 words.

The port of brotli_tpu/ops/bitpack.py, the serialization loop in its
data-parallel form: an exclusive scan of the bit lengths, each item
shifted to its bit offset and added into its u32 word and the next.
The items' bit ranges are disjoint, so the add is an or.  u32 values
ride in int64 masked with 0xFFFFFFFF (torch's uint32 has no shifts on
the CPU), and the scatter is index_add_.  It is held against
encode/bitstream.pack_bits, the host's u64 packer; no encode path calls
it.
"""

from __future__ import annotations

import numpy as np
import torch

_U32 = 0xFFFFFFFF


def pack_bits_u32(bits: torch.Tensor, nbits: torch.Tensor,
                  total_words: int):
    """Pack items (each < 2^31, nbits <= 31) LSB-first into u32 words,
    on the device of `bits`.  total_words must be at least
    ceil(sum(nbits) / 32) + 1; a word past it is dropped, as the JAX
    version's mode="drop" scatter drops it.  Returns (words, int64
    [total_words] holding u32 values, total_bits, a 0-d int64
    tensor)."""
    bits = bits.to(torch.int64) & _U32
    nbits = nbits.to(torch.int64)
    dev = bits.device
    if bits.shape[0] == 0:
        return (torch.zeros(total_words, dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    pos = torch.cumsum(nbits, 0) - nbits          # exclusive scan
    total_bits = pos[-1] + nbits[-1]
    word = pos >> 5
    shift = pos & 31
    lo = (bits << shift) & _U32
    hi = torch.where(shift > 0, bits >> (32 - shift),
                     torch.zeros_like(bits))
    # one spare slot takes every item past total_words
    words = torch.zeros(total_words + 1, dtype=torch.int64, device=dev)
    words.index_add_(0, torch.clamp(word, max=total_words), lo)
    words.index_add_(0, torch.clamp(word + 1, max=total_words), hi)
    return words[:total_words], total_bits


def words_u32_to_bytes(words, total_bits: int) -> np.ndarray:
    """Host: u32 words (numpy, or a tensor on any device) -> the
    ceil(total_bits / 8) bytes they hold, the bits past total_bits in
    the last byte cleared."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    total_bits = int(total_bits)
    nbytes = (total_bits + 7) >> 3
    raw = np.frombuffer(
        np.ascontiguousarray(words, dtype="<u4").tobytes()[:nbytes],
        dtype=np.uint8).copy()
    if total_bits & 7:
        raw[-1] &= (1 << (total_bits & 7)) - 1
    return raw
