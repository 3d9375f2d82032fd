"""Share of the window (%) in the host's merge of the q9 matcher's two
folds and the extension of its capped lengths: invert_extend_share.
compress's reader (the program's host_parse.invert and
host_parse.extend spans; in q9 calls native_bridge.invert_merge32,
which applies both folds' permutations, and extend_caps at 16 and 8
bytes), loaded by path.  Layer: gpu_path._host_parse."""

import os

from harness import _load_file

_compress = _load_file(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "invert_extend_share.compress.py"), __name__)
COUNTERS = _compress.COUNTERS
read = _compress.read
