"""brotli_tpu_torch: brotli_tpu in PyTorch + CUDA.

The port of brotli_tpu to an NVIDIA H100.  It imports torch and numpy,
never jax and nothing of brotli_tpu: the host-side tables and helpers
it needs are its own copies, and the C++ runtime in native/ is built by
its own bridge (native_bridge.py).

Host entry points (the native runtime, no tensor, no torch import):

  compress(data, quality=11, lgwin=22, lgblock=0, mode=0, catable=False,
           appendable=False, bare=False, byte_align=False,
           magic_number=False, large_window=False, custom_dictionary=b"",
           q9_5=False, q10_deep=False, ..., metablock_callback=None)
      -> bytes
      q0-q11 (and 12, the deeper -q9.5y tier), byte-identical to
      brotli_tpu.compress; quality 10 and above run the optimal parser
  decompress(data, custom_dictionary=b"", large_window=False) -> bytes
      the native decoder, or Decoder where the runtime does not build;
      raises BrotliDecodeError (corrupt) or NeedsMoreInput (truncated)
  Decoder(custom_dictionary=b"", large_window=False).decompress(data)
      the pure-Python one-shot decoder, equal to brotli_tpu.Decoder
  decompress_batch(streams, custom_dictionary=b"", large_window=False,
                   threads=8, size_hints=None) -> list of bytes
      independent streams decoded side by side
  compress_multi(data, num_parts, quality=9, lgwin=22, mode=0,
                 backend="thread", favor_cpu_efficiency=False) -> bytes
      parts compressed side by side and merged with BroCatli (backends
      thread, serial, process, workpool), byte-identical to
      brotli_tpu.compress_multi
  compress_batch(payloads, threads=8, **params) -> list of bytes
      independent payloads through compress(), side by side
  EncoderParams, BroCatli, BroCatliResult, concatenate(streams)

Streaming (host, byte-identical to brotli_tpu's):

  Compressor(quality=9, lgwin=22, mode=0, chunk_size=None, lgblock=0,
             custom_dictionary=b"", catable=False, appendable=False,
             byte_align=False, magic_number=False, stream_offset=0)
      .process(data) / .flush() / .emit_metadata(payload) / .finish()
      -> bytes each; one metablock a chunk
  StreamDecoder(custom_dictionary=b"", large_window=False)
      .decompress(chunk, max_output=None) / .finish() -> bytes each;
      resumes at any input byte, keeps only the window
  CompressorReader / CompressorWriter / Decompressor /
  DecompressorWriter   file-object wrappers around the two
  brotli_tpu_torch.ffi   the C API's shape (BrotliEncoder* and
      BrotliDecoder* functions, states and constants)

Device entry points (imported at first use; they import torch):

  compress_gpu(data, quality=9, lgwin=22, mode=0, span=None,
               stats=None, max_device=False, device=None) -> bytes
      q2-q9, byte-identical to brotli_tpu's compress_tpu
  compress_fast(data, lgwin=22, quality=1, device=None) -> bytes
      q0/q1, byte-identical to brotli_tpu.encode.fast.compress_fast
  decompress_batch_gpu(streams, max_rounds=8, device=None)
      -> (outputs, n_device), equal to brotli_tpu's decompress_batch_tpu
  compress_mesh(data, mesh=None, n_shards=None, quality=9, lgwin=22,
                lgblock=0, device=None, stats=None) -> bytes
      shards with window halos, merged with BroCatli; byte-identical
      to brotli_tpu's compress_mesh over as many devices
  make_mesh(n_devices=None, device=None) -> list of torch.device
      shard i on CUDA card i % device_count, or every shard on `device`

The device entry points run on CUDA unless device="cpu" is passed;
without CUDA and without device="cpu" they raise.  The match fold
(csrc/fold.cu), the match-length round chain (csrc/match_rounds.cu) and
the batch decoder's per-lane symbol loop (csrc/decode_step.cu) are CUDA
C++ kernels built with nvcc at first use; on CPU tensors their plain
PyTorch versions run instead.
"""

import importlib

from .concat.brocatli import BroCatli, BroCatliResult, concatenate
from .decode.batch import decompress_batch
from .decode.decoder import BrotliDecodeError, Decoder, decompress
from .decode.stream import StreamDecoder
from .encode.batch import compress_batch
from .encode.encoder import compress
from .encode.params import EncoderParams
from .encode.streaming import Compressor
from .io_wrappers import (CompressorReader, CompressorWriter, Decompressor,
                          DecompressorWriter)
from .parallel.multi import compress_multi

__version__ = "0.1.0"

# the device entry points and the modules that hold them
_DEVICE_ENTRIES = {
    "compress_fast": ".encode.fast",
    "compress_gpu": ".encode.gpu_path",
    "compress_mesh": ".parallel.mesh",
    "decompress_batch_gpu": ".decode.batch_gpu",
    "make_mesh": ".parallel.mesh",
    "resolve_device": ".device",
}


def __getattr__(name):
    """A device entry point, imported at its first use: the host
    encoder's process workers import this package without torch."""
    if name not in _DEVICE_ENTRIES:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(_DEVICE_ENTRIES[name],
                                            __name__), name)
    globals()[name] = value
    return value


__all__ = ["BroCatli", "BroCatliResult", "BrotliDecodeError", "Compressor",
           "CompressorReader", "CompressorWriter", "Decoder",
           "Decompressor", "DecompressorWriter", "EncoderParams",
           "StreamDecoder", "__version__", "compress", "compress_batch",
           "compress_fast", "compress_gpu", "compress_mesh",
           "compress_multi", "concatenate", "decompress",
           "decompress_batch", "decompress_batch_gpu", "make_mesh",
           "resolve_device"]
