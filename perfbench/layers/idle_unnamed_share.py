"""Share of the window (%) in which a call is open, the device is idle
and no program span below the call's root is open: the device's idle
gaps (CUPTI, mapped onto the host clock by DeviceTrace.to_host)
intersected with the calls, less their overlap with the program's
spans, by exact interval overlap.  What it leaves is the entry's own
code that no span names.  The idle time of every named span, split the
same way, goes to standard error.  Layer: the device, under any entry;
the reader of idle_unnamed_share.<entry>."""

import sys

from program_spans import UNNAMED, idle_split, traced

COUNTERS = "stats"


def host_gaps(dt) -> list:
    """The device's idle gaps as (t0, t1) in host seconds."""
    return [(dt.to_host(a), dt.to_host(b)) for a, b in dt.idle_gaps()]


def read(ctx):
    stats = traced(ctx)
    if ctx.device is None or not stats:
        return None
    split = idle_split(host_gaps(ctx.device), ctx.calls(), stats)
    top = sorted(split.items(), key=lambda kv: -kv[1])
    print("idle_unnamed_share: device idle by innermost program span (s): "
          + ", ".join(f"{k} {v:.6f}" for k, v in top), file=sys.stderr)
    return 100.0 * split[UNNAMED] / ctx.window_s
