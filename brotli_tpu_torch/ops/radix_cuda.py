"""The radix-sort probes' primitives: CUDA kernels + wrappers.

Counterparts of the six Pallas kernels of research/radix_probe.py and
research/radix_probe2.py, the building blocks a counting sort on the
device would be made of.  Each works on an int32 array of rows of 128
lanes, `[rows, 128]`, contiguous:

  gather_rows   take_along_axis(axis=0) inside each block of R rows
  gather_lanes  take_along_axis(axis=1) inside each row
  hist8         per 2048-row tile and lane, the count of x & 7 in 8 rows
  run_copy      runs of rows from src to dst at the same offsets
  cmpex3        three roll + min/max + select stages (s = 1, 2, 4) inside
                each 2048-row tile

On CUDA tensors each wrapper launches its kernel in csrc/radix_probe.cu
(built with nvcc for sm_90a at first use, loaded with ctypes) or
raises; on CPU tensors it runs its plain PyTorch version `*_ref`.
Indices and offsets are taken to be in range, as the probes make them:
gather_rows' in [0, R), gather_lanes' in [0, 128), run_copy's in
[0, rows - run_rows].  LAUNCHES counts kernel launches, gather_rows'
under "gather_rows_R<R>".  gather_rows_plan, gather_lanes_plan and
hist8_plan give the route and grid a kernel launches with.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..buildcache import CudaLibrary

LANES = 128
TILE = 2048   # rows of a hist8 / cmpex3 tile
STRIP = 16384   # elements of x a gather_rows CTA stages (64 KiB)
SMEM_MAX_R = 2048   # the widest R gather_rows stages in shared memory
MAX_ROWS = (1 << 31) // LANES   # the kernels' offsets are 32-bit
ROUTES = {"smem": 0, "l2": 1}
LANE_ROWS_PER_CTA = 32   # gather_lanes: 8 warps x 4 rows in flight
HIST8_CLUSTER = 4   # CTAs that split a hist8 tile (kHistCluster; PERF.md)
HIST8_GROUP = 32    # lanes a hist8 CTA counts

#: kernel launches by name; reset and read by callers that check a run
#: went through the kernels
LAUNCHES: dict[str, int] = {}


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gather_rows_launch.argtypes = [vp, vp, vp] + [ci] * 8 + [vp]
    lib.gather_lanes_launch.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.hist8_launch.argtypes = [vp, vp, ci, vp]
    lib.run_copy_launch.argtypes = [vp, vp, vp, ci, ci, vp]
    lib.cmpex3_launch.argtypes = [vp, vp, ci, vp]
    for fn in (lib.gather_rows_launch, lib.gather_lanes_launch,
               lib.hist8_launch, lib.run_copy_launch, lib.cmpex3_launch):
        fn.restype = ci


LIB = CudaLibrary("radix_probe", _bind)


def _check_rows(name: str, *xs: torch.Tensor, multiple: int = 1) -> str:
    """Raise unless every x is a contiguous int32 [rows, 128] tensor of
    one shape on one device with rows a multiple of `multiple`; returns
    the device type ("cpu" or "cuda")."""
    shape, dev = xs[0].shape, xs[0].device
    ok = len(shape) == 2 and shape[1] == LANES and shape[0] % multiple == 0
    for t in xs:   # a plain loop: this runs on every launch
        ok = ok and t.dtype == torch.int32 and t.shape == shape \
            and t.device == dev and t.is_contiguous()
    if not ok:
        raise ValueError(f"{name}: want contiguous int32 [rows, {LANES}] "
                         f"tensors of one shape on one device, rows a "
                         f"multiple of {multiple}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type


def _launch(name: str, dev: torch.device, fn, *args) -> None:
    """fn(*args, stream) on the current stream of `dev`, switching the
    current device only when it is another one; raises on a CUDA error.
    The stream is the raw handle: torch.cuda.current_stream() builds a
    Stream object, 5-7 us a call on the host of an NVIDIA H100 80GB
    HBM3, 700.00 W (PERF.md)."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    if ts[0].shape[0] > MAX_ROWS or any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: want at most {MAX_ROWS} rows and "
                         "16-byte aligned tensors")


@functools.lru_cache(maxsize=None)
def gather_rows_plan(rows: int, rows_per_block: int) -> dict:
    """The route and grid gather_rows launches with on `rows` rows in
    blocks of R = rows_per_block, the one place they are decided.
    "smem" at R <= 2048: a strip of R rows x `lanes` lanes staged in
    shared memory, lanes the widest power of two up to 128 with R x
    lanes <= 16,384, `blocks_per_cta` R-blocks a CTA, `smem_bytes` of
    dynamic shared memory; "l2" beyond (no staging; on an H100 strips of
    4 lanes are slower than reads through L2, PERF.md).  `grid` is the
    (x, y) grid of CTAs of 256 threads, `ctas` their number."""
    r = rows_per_block
    if r < 1 or rows % r or not 0 < rows <= MAX_ROWS:
        raise ValueError(f"gather_rows: no plan for {rows} rows in blocks "
                         f"of {r}")
    n_blocks = rows // r
    if r <= SMEM_MAX_R:
        lanes = LANES
        while r * lanes > STRIP:
            lanes //= 2
        g = min(STRIP // (r * lanes), n_blocks)
        grid = (-(-n_blocks // g) * (LANES // lanes), 1)
        plan = dict(route="smem", lanes=lanes, blocks_per_cta=g,
                    smem_bytes=g * r * lanes * 4)
    else:
        grid = (-(-r * (LANES // 4) // 256), n_blocks)
        plan = dict(route="l2", lanes=LANES, blocks_per_cta=1, smem_bytes=0)
    return dict(plan, grid=grid, ctas=grid[0] * grid[1])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gather_lanes_plan(rows: int, sms: int) -> dict:
    """gather_lanes' grid on `rows` rows and a card of `sms` SMs: CTAs of
    8 warps, 4 rows in flight a warp, at most 8 CTAs an SM (the warps
    stride over the rest)."""
    return dict(route="warp", ctas=min(-(-rows // LANE_ROWS_PER_CTA),
                                       8 * sms),
                smem_bytes=LANE_ROWS_PER_CTA * LANES * 4)


def hist8_plan(rows: int) -> dict:
    """hist8's grid on `rows` rows: each 2048-row tile and 32-lane group
    split over a cluster of HIST8_CLUSTER CTAs of 256 threads, 2048 /
    HIST8_CLUSTER rows each; `smem_bytes` per CTA: 128 x 32 words of two
    16-bit digit counters and the [8, 32] partial the cluster sums."""
    if rows % TILE or not 0 <= rows <= MAX_ROWS:
        raise ValueError(f"hist8: no plan for {rows} rows")
    ctas = rows // TILE * HIST8_CLUSTER * (LANES // HIST8_GROUP)
    return dict(cluster=HIST8_CLUSTER, ctas=ctas, threads=256,
                rows_per_cta=TILE // HIST8_CLUSTER,
                smem_bytes=4 * 128 * HIST8_GROUP + 4 * 8 * HIST8_GROUP)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def gather_rows_ref(x: torch.Tensor, idx: torch.Tensor,
                    rows_per_block: int) -> torch.Tensor:
    """out[b*R + i, l] = x[b*R + idx[b*R + i, l], l]: torch.gather on
    the [blocks, R, 128] view."""
    r = rows_per_block
    xv = x.view(-1, r, LANES)
    return torch.gather(xv, 1, idx.view(-1, r, LANES).long()).view(x.shape)


def gather_lanes_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[r, l] = x[r, idx[r, l]]."""
    return torch.gather(x, 1, idx.long())


def hist8_ref(x: torch.Tensor) -> torch.Tensor:
    """The TPU body's 256 equality sweeps over each 2048-row tile's low
    byte, digit d's per-lane count accumulated into row d % 8 of the
    tile's 8 output rows: int32 [8 * rows / 2048, 128]."""
    d8 = (x & 0xFF).view(-1, TILE, LANES)
    acc = torch.zeros((d8.shape[0], 8, LANES), dtype=torch.int32,
                      device=x.device)
    for d in range(256):
        acc[:, d % 8] += (d8 == d).sum(1, dtype=torch.int32)
    return acc.view(-1, LANES)


def run_copy_ref(src: torch.Tensor, dst: torch.Tensor, offs: torch.Tensor,
                 run_rows: int) -> torch.Tensor:
    """dst[o:o + run_rows] = src[o:o + run_rows] for each offset o, in
    order; returns dst."""
    for o in offs.tolist():
        dst[o:o + run_rows] = src[o:o + run_rows]
    return dst


def cmpex3_ref(x: torch.Tensor) -> torch.Tensor:
    """Stages s = 1, 2, 4 inside each 2048-row tile: y = x rolled by s
    rows (y[i] = x[i - s mod 2048]), x = min(x, y) where (i // s) % 2 ==
    0, else max(x, y), i the row inside the tile."""
    t = x.view(-1, TILE, LANES)
    i = torch.arange(TILE, device=x.device)[None, :, None]
    for s in (1, 2, 4):
        y = torch.roll(t, s, dims=1)
        t = torch.where((i // s) % 2 == 0, torch.minimum(t, y),
                        torch.maximum(t, y))
    return t.reshape(x.shape)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                rows_per_block: int) -> torch.Tensor:
    """take_along_axis(axis=0) inside each block of `rows_per_block`
    rows (research/radix_probe.py P2, radix_probe2.py Q1).  On the card
    it launches the route and grid of gather_rows_plan."""
    r = int(rows_per_block)
    if r < 1:
        raise ValueError("gather_rows: rows_per_block must be >= 1")
    if _check_rows("gather_rows", x, idx, multiple=r) == "cpu":
        return gather_rows_ref(x, idx, r)
    _check_cuda("gather_rows", x, idx)
    lib = LIB.get()
    out = torch.empty_like(x)
    rows = x.shape[0]
    if rows:
        p = gather_rows_plan(rows, r)
        _launch(f"gather_rows_R{r}", x.device, lib.gather_rows_launch,
                x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, r,
                ROUTES[p["route"]], p["lanes"], p["blocks_per_cta"],
                *p["grid"], p["smem_bytes"])
    return out


def gather_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis(axis=1) inside each row (research/radix_probe.py
    P2, gather1_kernel)."""
    if _check_rows("gather_lanes", x, idx) == "cpu":
        return gather_lanes_ref(x, idx)
    _check_cuda("gather_lanes", x, idx)
    lib = LIB.get()
    out = torch.empty_like(x)
    rows = x.shape[0]
    if rows:
        ctas = gather_lanes_plan(rows, _sm_count(x.device.index))["ctas"]
        _launch("gather_lanes", x.device, lib.gather_lanes_launch,
                x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, ctas)
    return out


def hist8(x: torch.Tensor) -> torch.Tensor:
    """Per 2048-row tile and lane, the count of rows with x & 7 == q in
    output row 8 * tile + q (research/radix_probe.py P3, the function
    hist_kernel's body means).  On the card it launches hist8_plan's
    grid."""
    if _check_rows("hist8", x, multiple=TILE) == "cpu":
        return hist8_ref(x)
    rows = x.shape[0]
    if rows > MAX_ROWS:
        raise ValueError(f"hist8: want at most {MAX_ROWS} rows")
    out = x.new_empty((8 * rows // TILE, LANES))
    if rows:
        _launch("hist8", x.device, LIB.get().hist8_launch, x.data_ptr(),
                out.data_ptr(), rows)
    return out


def run_copy(src: torch.Tensor, dst: torch.Tensor, offs: torch.Tensor,
             run_rows: int) -> torch.Tensor:
    """Copy rows [o, o + run_rows) of src into dst for each offset o of
    the int32 vector `offs` (research/radix_probe.py P4); dst is the
    caller's and is returned.  Rows no run covers keep their value."""
    dev = _check_rows("run_copy", src, dst)
    if offs.dtype != torch.int32 or offs.dim() != 1 \
            or offs.device != src.device or run_rows < 1 \
            or run_rows > src.shape[0]:
        raise ValueError("run_copy: offs must be an int32 vector on the "
                         "rows' device and 1 <= run_rows <= rows")
    if dev == "cpu":
        return run_copy_ref(src, dst, offs, run_rows)
    if src.data_ptr() % 16 or dst.data_ptr() % 16:
        raise ValueError("run_copy: src and dst must be 16-byte aligned")
    lib = LIB.get()
    offs = offs.contiguous()
    if offs.numel():
        _launch("run_copy", src.device, lib.run_copy_launch, src.data_ptr(),
                dst.data_ptr(), offs.data_ptr(), offs.numel(), run_rows)
    return dst


def cmpex3(x: torch.Tensor) -> torch.Tensor:
    """Three compare-exchange stages inside each 2048-row tile
    (research/radix_probe.py P5); see cmpex3_ref."""
    if _check_rows("cmpex3", x, multiple=TILE) == "cpu":
        return cmpex3_ref(x)
    lib = LIB.get()
    out = torch.empty_like(x)
    _launch("cmpex3", x.device, lib.cmpex3_launch, x.data_ptr(),
            out.data_ptr(), x.shape[0])
    return out
