"""Input bytes over output bytes, summed over every file compressed in
the window: the ratio of the very streams the reference decodes."""


def read(ctx):
    done = [r for r in ctx.requests if r.ok]
    out = sum(r.bytes_out for r in done)
    return sum(r.bytes_in for r in done) / out if out else None
