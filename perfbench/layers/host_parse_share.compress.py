"""Share of the window (%) in gpu_path._host_parse: the inversion, the
extension of capped lengths, the dictionary probe, the greedy walk."""

from spans import intervals, length

WRAPS = ["brotli_tpu_torch.encode.gpu_path:_host_parse"]


def read(ctx):
    return 100.0 * length(intervals(ctx.spans(WRAPS[0]))) / ctx.window_s
