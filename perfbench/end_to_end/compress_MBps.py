"""Input bytes of every file compressed in the window over the window's
time (host clock; 1 MB = 10^6 bytes).  The window closes at the first
request boundary after --seconds, so no request is cut."""


def read(ctx):
    done = sum(r.bytes_in for r in ctx.requests if r.ok)
    return done / ctx.window_s / 1e6 if ctx.window_s > 0 else None
