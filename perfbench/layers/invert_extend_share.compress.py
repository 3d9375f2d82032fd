"""Share of the window (%) in the inversion and the cap extension of
compress_gpu's host leg: the program's host_parse.invert spans
(native_bridge.invert_perm32 / invert_merge32) and host_parse.extend
spans (native_bridge.extend_caps and the candidates' scores).  Layer:
gpu_path._host_parse."""

from program_spans import share

COUNTERS = "stats"


def read(ctx):
    return share(ctx, "host_parse.invert", "host_parse.extend")
