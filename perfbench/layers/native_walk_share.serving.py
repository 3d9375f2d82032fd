"""Share (%) of the batch decoder's header walks that the native
single-pass walk took: the program's counters walks_native over
walks_native + walks_python + walks_resumed, summed over the window's
calls.  Exact counts: two runs of one seed differ only in the number
of requests the window holds.  Layer: decode/batch_gpu host leg."""

from program_spans import total

COUNTERS = "stats"


def read(ctx):
    native = total(ctx, "walks_native")
    if native is None:
        return None
    walks = native + total(ctx, "walks_python") + total(ctx, "walks_resumed")
    return 100.0 * native / walks if walks else None
