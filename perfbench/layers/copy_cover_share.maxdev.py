"""Share (%) of the positions compress_gpu(max_device=True)'s device
parse committed over that its copies cover: the program's counters
parse.copied over parse.positions, summed over the window's calls.
Exact counts: two runs of one seed differ only in the files the window
holds.  What the mode gives up in ratio (copies capped at 24 bytes,
cut at 4096-byte seams, no static dictionary) shows here first.
Layer: gpu_path._match_parse_dense."""

from program_spans import total

COUNTERS = "stats"


def read(ctx):
    copied = total(ctx, "parse.copied")
    positions = total(ctx, "parse.positions")
    if copied is None or not positions:
        return None
    return 100.0 * copied / positions
