"""RFC 7932 static dictionary and word-transform tables.

A trimmed copy of brotli_tpu/core/dictionary.py: the tables load from
this package's data/ directory (dictionary.bin, dictionary_meta.npz,
transforms.npz).  The encoder's dictionary matchers, the native
decoder's dictionary install, the batch decoder (transform output
lengths, RFC 7932 section 8) and the host Decoder (resolve) read them.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from .constants import (
    MAX_DICTIONARY_WORD_LENGTH,
    MIN_DICTIONARY_WORD_LENGTH,
    NUM_TRANSFORMS,
)

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "data")

# Transform types (RFC 7932 Appendix B)
OMIT_LAST_1, OMIT_LAST_9 = 1, 9
UPPERCASE_FIRST = 10
UPPERCASE_ALL = 11
OMIT_FIRST_1, OMIT_FIRST_9 = 12, 20


class StaticDictionary:
    def __init__(self):
        with open(os.path.join(_DATA_DIR, "dictionary.bin"), "rb") as f:
            self.data = f.read()
        if len(self.data) != 122784:
            raise ValueError("dictionary.bin has the wrong size")
        meta = np.load(os.path.join(_DATA_DIR, "dictionary_meta.npz"))
        self.size_bits_by_length = meta["size_bits_by_length"]
        self.offsets_by_length = meta["offsets_by_length"]
        t = np.load(os.path.join(_DATA_DIR, "transforms.npz"))
        self.t_prefix = [bytes(t["prefix"][i][:t["prefix_len"][i]])
                         for i in range(NUM_TRANSFORMS)]
        self.t_suffix = [bytes(t["suffix"][i][:t["suffix_len"][i]])
                         for i in range(NUM_TRANSFORMS)]
        self.t_type = [int(x) for x in t["type"]]

    def num_words(self, length: int) -> int:
        if not (MIN_DICTIONARY_WORD_LENGTH <= length
                <= MAX_DICTIONARY_WORD_LENGTH):
            return 0
        return 1 << int(self.size_bits_by_length[length])

    def word(self, length: int, index: int) -> bytes:
        off = int(self.offsets_by_length[length]) + length * index
        return self.data[off:off + length]

    def transformed(self, length: int, index: int,
                    transform_id: int) -> bytes:
        return apply_transform(self, self.word(length, index), transform_id)

    def resolve(self, copy_len: int, word_id: int) -> bytes:
        """The output of a dictionary reference (RFC 7932 section 8):
        word_id is its 0-based address beyond the maximum distance.
        Raises ValueError for an invalid reference."""
        n = self.num_words(copy_len)
        if n == 0:
            raise ValueError(f"invalid dictionary word length {copy_len}")
        index = word_id & (n - 1)
        transform_id = word_id >> int(self.size_bits_by_length[copy_len])
        if transform_id >= NUM_TRANSFORMS:
            raise ValueError(f"invalid transform id {transform_id}")
        return self.transformed(copy_len, index, transform_id)


def _ferment(buf: bytearray, i: int) -> int:
    """RFC 7932 'ferment' (uppercase) step; returns bytes consumed."""
    c = buf[i]
    if c < 192:
        if ord("a") <= c <= ord("z"):
            buf[i] = c ^ 32
        return 1
    if c < 224:
        if i + 1 < len(buf):
            buf[i + 1] ^= 32
        return 2
    if i + 2 < len(buf):
        buf[i + 2] ^= 5
    return 3


def apply_transform(d: StaticDictionary, word: bytes,
                    transform_id: int) -> bytes:
    ty = d.t_type[transform_id]
    w = bytearray(word)
    if OMIT_FIRST_1 <= ty <= OMIT_FIRST_9:
        w = w[ty - (OMIT_FIRST_1 - 1):]
    elif OMIT_LAST_1 <= ty <= OMIT_LAST_9:
        w = w[:-ty] if len(w) > ty else bytearray()
    if ty == UPPERCASE_FIRST:
        if w:
            _ferment(w, 0)
    elif ty == UPPERCASE_ALL:
        i = 0
        while i < len(w):
            i += _ferment(w, i)
    return d.t_prefix[transform_id] + bytes(w) + d.t_suffix[transform_id]


@lru_cache(maxsize=1)
def get_dictionary() -> StaticDictionary:
    return StaticDictionary()
