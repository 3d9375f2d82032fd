"""The fold kernel's share of its roofline (%) in compress_gpu's q9
calls, on the short fold's launches (1 key, 1 payload, 16 forward
offsets): fold_roofline.q9's reader, loaded by path under this metric's
name, on the other form the q9 matcher launches."""

import os

from harness import _load_file

_q9 = _load_file(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "fold_roofline.q9.py"), __name__)
WRAPS = _q9.WRAPS


def read(ctx):
    return _q9.read_form(ctx, _q9.SHORT)
