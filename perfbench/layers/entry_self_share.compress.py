"""Share of the window (%) that compress_gpu spends in its own code: the
call's wall less the spans below it (the host leg, the serializer, the
wait on the device).  That is the row build, the link probe, the pinned
allocations, the context choice.  Layer: encode/gpu_path.compress_gpu."""

from spans import inside, intervals, length

WRAPS = ["brotli_tpu_torch.encode.gpu_path:_host_parse",
         "brotli_tpu_torch.native_bridge:encode_metablock",
         "brotli_tpu_torch.encode.gpu_path:split_symbols_device",
         "brotli_tpu_torch.encode.gpu_path:_Pipeline.wait"]


def read(ctx):
    calls = ctx.calls()
    below = [iv for p in WRAPS for iv in intervals(ctx.spans(p))]
    own = length(calls) - inside(below, calls)
    return 100.0 * own / ctx.window_s
