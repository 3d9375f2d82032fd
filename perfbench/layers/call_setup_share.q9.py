"""Share of the window (%) in the per-call set-up of compress_gpu's q9
calls, whose slots each hold six full-row outputs: call_setup_share.
compress's reader (the program's entry.call_setup spans), loaded by
path.  Layer: encode/gpu_path.compress_gpu."""

import os

from harness import _load_file

_compress = _load_file(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "call_setup_share.compress.py"), __name__)
COUNTERS = _compress.COUNTERS
read = _compress.read
