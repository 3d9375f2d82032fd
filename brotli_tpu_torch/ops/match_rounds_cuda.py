"""Match-length round chain: CUDA kernel + wrappers.

Counterpart of brotli_tpu/ops/pallas_match.py.  Two forms of one CUDA
C++ kernel (csrc/match_rounds.cu, built with nvcc for sm_90a at first
use, loaded with ctypes):

  match_rounds(va, vb)          the two-operand chain, the direct
                                counterpart of match_rounds_pallas
                                (match_lengths_blocked runs over it)
  match_rounds_shifted(va, k)   the fold form: the chains of va against
                                its shift by j = 1..k in one launch,
                                as ops/matching._fold_sorted (the q0/q1
                                matcher) needs them

On CUDA tensors each launches its kernel or raises; on CPU tensors each
runs its plain PyTorch version (match_rounds_ref,
match_rounds_shifted_ref).  LAUNCHES counts kernel launches under
"match_rounds", "match_rounds_shifted" and, by offsets,
"match_rounds_shifted_k<k>"; LAST_PLAN holds the grid of the last
launch (match_rounds_plan).
"""

from __future__ import annotations

import ctypes

import torch

from ..buildcache import CudaLibrary
from .matching import as_i32, ctz_bytes

#: kernel launches (see the module docstring); reset and read by callers
#: that check a run went through the kernels
LAUNCHES: dict[str, int] = {}
#: match_rounds_plan's grid of the last launch, with its form, offsets
#: (k), rounds and rows
LAST_PLAN: dict = {}

THREADS = 128                # csrc/match_rounds.cu: one row a thread
MAX_K = 8                    # the fold form's most offsets a launch
MAX_ROWS = (1 << 31) - 1


def _bind(lib) -> None:
    vp, ci, c64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.match_rounds_launch.argtypes = [vp, vp, vp, ci, c64, ci, c64, vp]
    lib.match_rounds_launch.restype = ci
    lib.match_rounds_shifted_launch.argtypes = [vp, vp, ci, c64, ci, ci,
                                                c64, vp]
    lib.match_rounds_shifted_launch.restype = ci


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


def shift_rounds(va: torch.Tensor, j: int) -> torch.Tensor:
    """va shifted right by j along the rows, zero words where m < j: the
    second operand of offset j in the fold."""
    vb = torch.zeros_like(va)
    if j < va.shape[1]:
        vb[:, j:] = va[:, :va.shape[1] - j]
    return vb


def match_rounds_shifted_ref(va: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version of the fold form: int32 [k, M], row j - 1 the chain
    of va against shift_rounds(va, j)."""
    return torch.stack([match_rounds_ref(va, shift_rounds(va, j))
                        for j in range(1, k + 1)])


def match_rounds_plan(m: int) -> dict:
    """The grid of either form on m rows, the one place it is decided:
    one row a thread, THREADS a CTA."""
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"match_rounds_plan: no plan for {m} rows")
    return dict(threads=THREADS, ctas=-(-m // THREADS))


def _launched(keys: tuple, err: int, plan: dict) -> None:
    if err != 0:
        raise RuntimeError(f"{keys[0]}_launch failed: CUDA error {err}")
    for key in keys:
        LAUNCHES[key] = LAUNCHES.get(key, 0) + 1
    LAST_PLAN.clear()
    LAST_PLAN.update(plan)


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
    plan = match_rounds_plan(m)
    lib = LIB.get()
    va, vb = va.contiguous(), vb.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.match_rounds_launch(va.data_ptr(), vb.data_ptr(),
                                      out.data_ptr(), rounds, m,
                                      plan["threads"], plan["ctas"], stream)
    _launched(("match_rounds",), err,
              dict(plan, form="two_operand", k=1, rounds=rounds, rows=m))
    return out


def match_rounds_shifted(va: torch.Tensor, k: int) -> torch.Tensor:
    """Lengths int32 [k, M]: row j - 1 the chain of va (int32 [R, M]
    carrying u32 bit patterns) against va shifted by j, zero words where
    m < j (match_rounds(va, shift_rounds(va, j)) for j = 1..k), in one
    launch that never builds the shifted copies.  CUDA tensors launch the
    kernel, CPU tensors run match_rounds_shifted_ref."""
    if va.dtype != torch.int32 or va.dim() != 2 or va.shape[0] < 1:
        raise ValueError("match_rounds_shifted: va must be an int32 "
                         "[R, M] tensor, R >= 1")
    if not isinstance(k, int) or not 1 <= k <= MAX_K:
        raise ValueError(f"match_rounds_shifted: k must be 1..{MAX_K}, "
                         f"not {k}")
    rounds, m = va.shape
    if m > MAX_ROWS:
        raise ValueError(f"match_rounds_shifted: {m} rows; at most "
                         f"{MAX_ROWS}")
    dev = va.device
    if dev.type == "cpu":
        return match_rounds_shifted_ref(va, k)
    if dev.type != "cuda":
        raise ValueError(f"match_rounds_shifted: unsupported device {dev}")
    out = torch.empty((k, m), dtype=torch.int32, device=dev)
    if m == 0:
        return out
    plan = match_rounds_plan(m)
    lib = LIB.get()
    va = va.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.match_rounds_shifted_launch(
            va.data_ptr(), out.data_ptr(), rounds, m, k, plan["threads"],
            plan["ctas"], stream)
    _launched(("match_rounds_shifted", f"match_rounds_shifted_k{k}"), err,
              dict(plan, form="shifted", k=k, rounds=rounds, rows=m))
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
