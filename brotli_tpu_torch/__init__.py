"""brotli_tpu_torch: brotli_tpu's device paths in PyTorch + CUDA.

The port of brotli_tpu's device tier to an NVIDIA H100.  It imports
torch and numpy, never jax and nothing of brotli_tpu: the host-side
tables and helpers it needs are its own trimmed copies, and the C++
runtime in native/ is built by its own bridge (native_bridge.py).

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

All of them run on CUDA unless device="cpu" is passed; without CUDA and
without device="cpu" they raise.  The match fold (csrc/fold.cu), the
match-length round chain (csrc/match_rounds.cu) and the batch decoder's
per-lane symbol loop (csrc/decode_step.cu) are CUDA C++ kernels built
with nvcc at first use; on CPU tensors their plain PyTorch versions run
instead.
"""

from .decode.batch_gpu import decompress_batch_gpu
from .device import resolve_device
from .encode.fast import compress_fast
from .encode.gpu_path import compress_gpu
from .parallel.mesh import compress_mesh, make_mesh

__all__ = ["compress_fast", "compress_gpu", "compress_mesh",
           "decompress_batch_gpu", "make_mesh", "resolve_device"]
