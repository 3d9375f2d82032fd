"""Share of the window (%) in the batch decoder's device rounds:
batch_gpu._run_device (ops/decode_gpu.batch_decode_device, the tree
build, the kernel, the counts and the realized outputs back to the
host) less the lane arrays it builds first (lane_arrays, the host
leg's)."""

from spans import inside, intervals, length

ROUND = "brotli_tpu_torch.decode.batch_gpu:_run_device"
LANES = "brotli_tpu_torch.decode.batch_gpu:lane_arrays"
WRAPS = [ROUND, LANES]


def read(ctx):
    rounds = intervals(ctx.spans(ROUND))
    own = length(rounds) - inside(intervals(ctx.spans(LANES)), rounds)
    return 100.0 * own / ctx.window_s
