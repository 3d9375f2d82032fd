"""Process start (/proc/self/stat) to window start: imports, builds (the
first run in a checkout), making the inputs from the seed, the
warm-up."""


def read(ctx):
    return ctx.setup_s
