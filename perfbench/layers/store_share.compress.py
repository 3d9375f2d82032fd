"""Share of the window (%) in the serializer as gpu_path calls it: the
native metablock store (native_bridge.encode_metablock) and the
literal block split on the device (ops/split.split_symbols_device)."""

from spans import intervals, length

WRAPS = ["brotli_tpu_torch.native_bridge:encode_metablock",
         "brotli_tpu_torch.encode.gpu_path:split_symbols_device"]


def read(ctx):
    return 100.0 * length([iv for p in WRAPS
                           for iv in intervals(ctx.spans(p))]) / ctx.window_s
