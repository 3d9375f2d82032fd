"""Share (%) of the positions compress_gpu's static-dictionary probe
took that a dictionary candidate won over the window's match: the
program's counters dict.won over dict.positions, summed over the
window's calls.  Exact counts: two runs of one seed differ only in the
files the window holds.  Layer: gpu_path._host_parse."""

from program_spans import total

COUNTERS = "stats"


def read(ctx):
    won = total(ctx, "dict.won")
    if won is None:
        return None
    positions = total(ctx, "dict.positions")
    return 100.0 * won / positions if positions else None
