"""The fold kernel's share of its roofline (%) in compress_gpu's
max_device calls, median over the window's launches: fold_roofline.
compress's reader (rooflines/fold.py from each launch's shapes over the
kernel's CUPTI time), loaded by path under this metric's name so that
it reads the launches recorded for this metric.  The max_device fold
has 1 key and 5 payloads (6 attested rounds); where a launch of another
form is recorded the metric reads nothing."""

import os

from harness import _load_file

_compress = _load_file(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "fold_roofline.compress.py"), __name__)
WRAPS = _compress.WRAPS
MAX_DEVICE = (1, 5)    # key words, payload words


def read(ctx):
    shapes = [(s.recs or {}).get(__name__)
              for s in ctx.spans(_compress.POINT)]
    if any(s is not None and s[1:3] != MAX_DEVICE for s in shapes):
        return None
    return _compress.read(ctx)
