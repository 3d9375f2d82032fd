"""Share of the window (%) in the host planning of the literal block
split: the union of the program's split.hysteresis and split.merge
spans (the run hysteresis and the header-cost merge that
ops/split.split_symbols_device runs on the host after the device's
Lloyd loop).  None where the program records no such span.  Layer: the
serializer, ops/split.split_symbols_device."""

from program_spans import named, share

COUNTERS = "stats"
NAMES = ("split.hysteresis", "split.merge")


def read(ctx):
    if not named(ctx, *NAMES):
        return None
    return share(ctx, *NAMES)
