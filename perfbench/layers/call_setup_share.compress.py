"""Share of the window (%) in compress_gpu's per-call set-up: the
program's entry.call_setup spans (the link probe _pick_device_invert,
the pipeline's stream and pinned input buffers, and the pinned output
buffers a slot's first dispatch allocates).  Layer:
encode/gpu_path.compress_gpu."""

from program_spans import share

COUNTERS = "stats"


def read(ctx):
    return share(ctx, "entry.call_setup")
