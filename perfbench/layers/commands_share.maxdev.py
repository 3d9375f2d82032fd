"""Share of the window (%) in which compress_gpu(max_device=True) turns
the device's parse into commands on the host: the program's
host_parse.commands spans (gpu_path._commands_from_parse).  None where
the program records no such span.  Layer: gpu_path._commands_from_parse."""

from program_spans import named, share

COUNTERS = "stats"


def read(ctx):
    if not named(ctx, "host_parse.commands"):
        return None
    return share(ctx, "host_parse.commands")
