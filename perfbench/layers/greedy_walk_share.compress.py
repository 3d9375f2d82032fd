"""Share of the window (%) in the greedy walk of compress_gpu's host
leg: the program's host_parse.walk spans (the native greedy walk).
Layer: gpu_path._host_parse."""

from program_spans import share

COUNTERS = "stats"


def read(ctx):
    return share(ctx, "host_parse.walk")
