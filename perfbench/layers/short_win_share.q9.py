"""Share (%) of the positions compress_gpu's q9 matcher took whose
merged match came from the short fold (its score strictly beat the
exact8 fold's): the program's counters match.short_won over
match.positions, summed over the window's calls.  Exact counts: two
runs of one seed differ only in the files the window holds.  None where
the program records no such counters.  Layer: gpu_path._host_parse."""

from program_spans import total

COUNTERS = "stats"


def read(ctx):
    won = total(ctx, "match.short_won")
    positions = total(ctx, "match.positions")
    if won is None or not positions:
        return None
    return 100.0 * won / positions
