"""Share of the window (%) in the batch decoder's host leg
(decode/batch_gpu): the header walks (_try_parse_stream,
_resume_parse_stream), the lane arrays (lane_arrays) and the LZ
execution (_reconstruct with lz_execute)."""

from spans import intervals, length

WRAPS = ["brotli_tpu_torch.decode.batch_gpu:_try_parse_stream",
         "brotli_tpu_torch.decode.batch_gpu:_resume_parse_stream",
         "brotli_tpu_torch.decode.batch_gpu:lane_arrays",
         "brotli_tpu_torch.decode.batch_gpu:_reconstruct"]


def read(ctx):
    return 100.0 * length([iv for p in WRAPS
                           for iv in intervals(ctx.spans(p))]) / ctx.window_s
