"""Share of the window (%) in the batch decoder's Python header walks:
the program's walk.python spans (a stream the native single-pass walk
declined) and walk.resume spans (a paused walk resumed after a round).
Layer: decode/batch_gpu host leg."""

from program_spans import share

COUNTERS = "stats"


def read(ctx):
    return share(ctx, "walk.python", "walk.resume")
