"""Share of the window (%) in which compress_gpu's host waits on the
device: the sum of the `device_wait_s` it reports in its `stats` dict
(the wait on each dispatch's event).  Layer: gpu_path._Pipeline."""

COUNTERS = "stats"


def read(ctx):
    waits = [c["device_wait_s"] for c in ctx.counters
             if "device_wait_s" in c]
    if not waits:
        return None
    return 100.0 * sum(waits) / ctx.window_s
