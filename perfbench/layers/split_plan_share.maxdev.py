"""Share of the window (%) in the host planning of the literal block
split in compress_gpu's max_device calls: split_plan_share.compress's
reader (the union of the split.hysteresis and split.merge spans),
loaded by path."""

import os

from harness import _load_file

_compress = _load_file(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "split_plan_share.compress.py"), __name__)
COUNTERS = _compress.COUNTERS
NAMES = _compress.NAMES
read = _compress.read
