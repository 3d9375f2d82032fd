"""Share of the window (%) in compress_gpu(max_device=True)'s device
parse as the host enqueues it: the program's pipe.parse spans (the
scores and ops/parse.committed_parse's chain of launches, inside
pipe.dispatch; not the fold before them).  None where the program
records no such span.  Layer: gpu_path._match_parse_dense."""

from program_spans import named, share

COUNTERS = "stats"


def read(ctx):
    if not named(ctx, "pipe.parse"):
        return None
    return share(ctx, "pipe.parse")
