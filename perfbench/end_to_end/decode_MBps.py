"""Decoded bytes of every request completed in the window over the
window's time (host clock; 1 MB = 10^6 bytes)."""


def read(ctx):
    done = sum(r.bytes_out for r in ctx.requests if r.ok)
    return done / ctx.window_s / 1e6 if ctx.window_s > 0 else None
