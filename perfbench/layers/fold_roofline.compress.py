"""The fold kernel's share of its roofline (%), median over the window's
launches: the least time the card could take on the launch's bytes and
operations (rooflines/fold.py, from the launch's shapes) over the
kernel's CUPTI time.  Each launch of fold_cuda.fold_sorted on a CUDA
tensor records its shapes; the trace's fold kernels are matched to them
in order."""

import statistics
import sys

from rooflines.fold import fold_bytes, fold_ops
from rooflines.peaks import bound_s

POINT = "brotli_tpu_torch.ops.fold_cuda:fold_sorted"
KERNEL = "fold_kernel"


def _shape(args, result):
    ops = list(args["ops_sorted"])
    if ops[0].device.type != "cuda":
        return None
    n_keys = int(args["n_keys"])
    return (int(ops[0].shape[0]), n_keys, len(ops) - n_keys - 1,
            int(args["k_fwd"]), int(args["k_back"]))


WRAPS = [(POINT, _shape)]


def read(ctx):
    if ctx.device is None:
        return None
    shapes = [s.recs[__name__] for s in ctx.spans(POINT)]
    shapes = [s for s in shapes if s is not None]
    kernels = ctx.device.kernels(KERNEL)
    if not shapes or len(shapes) != len(kernels):
        print(f"fold_roofline: {len(shapes)} launches recorded, "
              f"{len(kernels)} fold kernels traced", file=sys.stderr)
        return None
    shares = []
    for (n, n_keys, n_pay, k_fwd, k_back), (a, b) in zip(shapes, kernels):
        bound = bound_s(fold_bytes(n, n_keys, n_pay),
                        fold_ops(n, n_keys, k_fwd, k_back), ctx.kind)
        if bound is None or b <= a:
            return None
        shares.append(100.0 * bound[0] / ((b - a) / 1e9))
    return statistics.median(shares)
