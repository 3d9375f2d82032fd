"""Match-length round chain: CUDA kernel + wrappers.

Counterpart of brotli_tpu/ops/pallas_match.py.  `match_rounds` launches
the CUDA C++ kernel in csrc/match_rounds.cu on CUDA tensors (built with
nvcc for sm_90a at first use, loaded with ctypes) and runs the plain
PyTorch version `match_rounds_ref` on CPU tensors; on a CUDA tensor it
launches the kernel or raises.  LAUNCHES["match_rounds"] counts kernel
launches.

The chain is the length computation of ops/matching._fold_sorted (the
q0/q1 matcher), and match_lengths_blocked is the drop-in counterpart
of matching.match_lengths_capped over it.
"""

from __future__ import annotations

import ctypes

import torch

from ..buildcache import CudaLibrary
from .matching import as_i32, ctz_bytes

#: kernel launches, under the key "match_rounds"; reset and read by
#: callers that check a run went through the kernel
LAUNCHES: dict[str, int] = {}


def _bind(lib) -> None:
    vp = ctypes.c_void_p
    lib.match_rounds_launch.argtypes = [vp, vp, vp, ctypes.c_int,
                                        ctypes.c_int64, vp]
    lib.match_rounds_launch.restype = ctypes.c_int


LIB = CudaLibrary("match_rounds", _bind)


def match_rounds_ref(va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: out[m] = sum over rounds r of
    ctz_bytes(va[r, m] ^ vb[r, m]) while every earlier XOR was 0."""
    total = torch.zeros(va.shape[1], dtype=torch.int32, device=va.device)
    alive = torch.ones(va.shape[1], dtype=torch.bool, device=va.device)
    for r in range(va.shape[0]):
        x = va[r] ^ vb[r]
        total = total + torch.where(alive, ctz_bytes(x), 0)
        alive = alive & (x == 0)
    return total


def match_rounds(va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """Lengths int32 [M] from round operands va, vb: int32 [R, M]
    carrying u32 bit patterns.  CUDA tensors launch the kernel, CPU
    tensors run match_rounds_ref."""
    if va.dtype != torch.int32 or vb.dtype != torch.int32 \
            or va.dim() != 2 or va.shape != vb.shape \
            or va.device != vb.device or va.shape[0] < 1:
        raise ValueError("match_rounds: operands must be int32 [R, M] "
                         "tensors of one shape on one device, R >= 1")
    dev = va.device
    if dev.type == "cpu":
        return match_rounds_ref(va, vb)
    if dev.type != "cuda":
        raise ValueError(f"match_rounds: unsupported device {dev}")
    rounds, m = va.shape
    out = torch.empty(m, dtype=torch.int32, device=dev)
    if m == 0:
        return out
    lib = LIB.get()
    va, vb = va.contiguous(), vb.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.match_rounds_launch(va.data_ptr(), vb.data_ptr(),
                                      out.data_ptr(), rounds, m, stream)
    if err != 0:
        raise RuntimeError(f"match_rounds_launch failed: CUDA error {err}")
    LAUNCHES["match_rounds"] = LAUNCHES.get("match_rounds", 0) + 1
    return out


def match_lengths_blocked(v4: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, limit: torch.Tensor,
                          rounds: int = 8) -> torch.Tensor:
    """Drop-in counterpart of matching.match_lengths_capped: the round
    operands are gathered here, the chain runs in match_rounds.
    v4: int64 u32 values (matching.u32_values)."""
    n4 = v4.shape[0]
    offs = 4 * torch.arange(rounds, device=v4.device)[:, None]
    w = as_i32(v4)
    ia = torch.clamp(a.long()[None, :] + offs, 0, n4 - 1)
    ib = torch.clamp(b.long()[None, :] + offs, 0, n4 - 1)
    return torch.minimum(match_rounds(w[ia], w[ib]), limit.to(torch.int32))
