"""Share of the window (%) in gpu_path._host_parse in compress_gpu's q9
calls: host_parse_share.compress's reader (the wrap point), loaded by
path."""

import os

from harness import _load_file

_compress = _load_file(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "host_parse_share.compress.py"), __name__)
WRAPS = _compress.WRAPS
read = _compress.read
