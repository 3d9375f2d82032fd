"""The program's own spans and counters (brotli_tpu_torch/utils/trace.py):
an entry that takes `stats=` returns, in the dict a traced run passes,
`spans` as (name, parent index, t0_ns, t1_ns) on the perf_counter_ns
clock (parent -1 for the call's root) and one integer key per counter.
A reader of them sets COUNTERS = "stats" and reads ctx.counters, which
holds the window's calls only.  Where the program records none (an
entry without these spans), the readers find nothing and return None.
"""

from __future__ import annotations

from spans import inside, length, union

UNNAMED = "(entry's own code)"


def traced(ctx) -> list:
    """The window's stats dicts that hold spans."""
    return [c for c in ctx.counters if "spans" in c]


def named(ctx, *names) -> list:
    """(t0, t1) in host seconds of the spans called one of `names`."""
    want = set(names)
    return [(t0 / 1e9, t1 / 1e9) for c in traced(ctx)
            for n, _, t0, t1 in c["spans"] if n in want]


def share(ctx, *names):
    """The union of the spans called one of `names` as a share of the
    window (%); None where the program recorded no spans."""
    if not traced(ctx):
        return None
    return 100.0 * length(named(ctx, *names)) / ctx.window_s


def total(ctx, key: str):
    """A counter summed over the window's calls; None where no call
    reports it."""
    vals = [c[key] for c in ctx.counters if key in c]
    return sum(vals) if vals else None


def own_intervals(spans) -> list:
    """(name, t0, t1) in host seconds of each stretch of one call in
    which a span below the root is the innermost open one: its interval
    less its children's."""
    kids = {}
    for name, parent, t0, t1 in spans:
        kids.setdefault(parent, []).append((t0 / 1e9, t1 / 1e9))
    out = []
    for k, (name, parent, t0, t1) in enumerate(spans):
        if parent < 0:
            continue
        at = t0 / 1e9
        for a, b in union(kids.get(k, ())):
            if a > at:
                out.append((name, at, a))
            at = max(at, b)
        if t1 / 1e9 > at:
            out.append((name, at, t1 / 1e9))
    return out


def idle_split(idle, calls, stats) -> dict:
    """The device's idle time (s) inside the calls by the innermost
    program span open on the host, split exactly by overlap (not by a
    gap's midpoint): `idle` and `calls` are (t0, t1) in host seconds,
    `stats` the calls' dicts.  Where no span below a call's root is
    open, the idle time goes to UNNAMED."""
    by_name = {}
    for c in stats:
        for name, a, b in own_intervals(c["spans"]):
            by_name.setdefault(name, []).append((a, b))
    out = {name: inside(idle, ivs) for name, ivs in by_name.items()}
    below = [(t0 / 1e9, t1 / 1e9) for c in stats
             for _, parent, t0, t1 in c["spans"] if parent >= 0]
    out[UNNAMED] = inside(idle, calls) - inside(idle, below)
    return out
