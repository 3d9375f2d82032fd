"""The decode kernel's share of its roofline (%), median over the
window's launches: the least time the card could take on the launch's
bytes (rooflines/decode_step.py: the lanes' bits, code lengths and
state read once, the realized literals and commands written once) over
the kernel's CUPTI time.  Each batch_gpu._run_device call (one launch)
records its lanes and the counts they realized; the trace's
decode_step kernels are matched to them in order."""

import statistics
import sys

from rooflines.decode_step import lane_bytes
from rooflines.peaks import bound_s

POINT = "brotli_tpu_torch.decode.batch_gpu:_run_device"
KERNEL = "decode_step_kernel"


def _bytes(args, result):
    if args["dev"].type != "cuda":
        return None
    _, nlit, _, ncmd, end_bit, _, _ = result
    return sum(lane_bytes(ln.bit0, int(e), len(ln.dist_len), int(a), int(c))
               for ln, e, a, c in zip(args["lanes"], end_bit, nlit, ncmd))


WRAPS = [(POINT, _bytes)]


def read(ctx):
    if ctx.device is None:
        return None
    launches = [s.recs[__name__] for s in ctx.spans(POINT)]
    launches = [b for b in launches if b is not None]
    kernels = ctx.device.kernels(KERNEL)
    if not launches or len(launches) != len(kernels):
        print(f"decode_step_roofline: {len(launches)} launches recorded, "
              f"{len(kernels)} decode_step kernels traced", file=sys.stderr)
        return None
    shares = []
    for nbytes, (a, b) in zip(launches, kernels):
        bound = bound_s(nbytes, 0, ctx.kind)
        if bound is None or b <= a:
            return None
        shares.append(100.0 * bound[0] / ((b - a) / 1e9))
    return statistics.median(shares)
