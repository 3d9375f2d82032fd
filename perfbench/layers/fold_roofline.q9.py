"""The fold kernel's share of its roofline (%) in compress_gpu's q9
calls, on the exact8 fold's launches (2 keys, 2 payloads, 16 forward
and 8 backward offsets), median over the window's: fold_roofline.
compress's record of each launch's shapes, loaded by path under this
metric's name, and its bound (rooflines/fold.py) over the kernel's
CUPTI time.  The q9 matcher launches two forms a span, this one and the
short fold's (short_fold_roofline.q9): every recorded launch is paired
with the traced fold kernel in its place, and the metric reads the
pairs of its form.  None where the counts of launches and kernels
differ or a launch of a third form is recorded."""

import os
import statistics
import sys

from harness import _load_file
from rooflines.fold import fold_bytes, fold_ops
from rooflines.peaks import bound_s

_compress = _load_file(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "fold_roofline.compress.py"), __name__)
WRAPS = _compress.WRAPS
MAIN = (2, 2, 16, 8)     # key words, payload words, offsets fwd / back
SHORT = (1, 1, 16, 0)


def read_form(ctx, form):
    """The median share of the launches of `form` (MAIN or SHORT)."""
    if ctx.device is None:
        return None
    shapes = [(s.recs or {}).get(__name__)
              for s in ctx.spans(_compress.POINT)]
    shapes = [s for s in shapes if s is not None]
    kernels = ctx.device.kernels(_compress.KERNEL)
    if len(shapes) != len(kernels) or any(s[1:] not in (MAIN, SHORT)
                                          for s in shapes):
        print(f"fold_roofline.q9: {len(shapes)} launches recorded, "
              f"{len(kernels)} fold kernels traced, forms "
              f"{sorted({s[1:] for s in shapes})}", file=sys.stderr)
        return None
    shares = []
    for (n, n_keys, n_pay, k_fwd, k_back), (a, b) in zip(shapes, kernels):
        if (n_keys, n_pay, k_fwd, k_back) != form:
            continue
        bound = bound_s(fold_bytes(n, n_keys, n_pay),
                        fold_ops(n, n_keys, k_fwd, k_back), ctx.kind)
        if bound is None or b <= a:
            return None
        shares.append(100.0 * bound[0] / ((b - a) / 1e9))
    return statistics.median(shares) if shares else None


def read(ctx):
    return read_form(ctx, MAIN)
