"""The 95th percentile of every request's latency in the window, from
its arrival (in a closed loop, its call) to its outputs on the host
(host clock).  A failed request counts with the time it took to
fail."""

import statistics
import sys


def read(ctx):
    lat = [r.latency_s * 1e3 for r in ctx.requests]
    if len(lat) < 2:
        return None
    if len(lat) < 200:
        print(f"request_p95_ms: {len(lat)} requests, under the 200 that "
              "put ten beyond the 95th percentile", file=sys.stderr)
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
