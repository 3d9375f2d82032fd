"""Share of the window (%) in the serializer of compress_gpu's q9 calls,
which runs the full command and distance block splitters and the
bigram test of the literal context: store_share.compress's reader (the
native metablock store and the literal split on the device, by their
wrap points), loaded by path."""

import os

from harness import _load_file

_compress = _load_file(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "store_share.compress.py"), __name__)
WRAPS = _compress.WRAPS
read = _compress.read
