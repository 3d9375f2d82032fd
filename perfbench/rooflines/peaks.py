"""Published peaks of the chips the benchmark runs on.

NVIDIA H100 SXM data sheet, dense rates, at the full power limit of
700 W (a card set lower runs slower under load; every run prints the
card's power limit beside these): HBM3 at 3.35 TB/s, and 67 T/s for
32-bit work outside the tensor cores, taken as the integer rate.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "int_ops_per_s": 67e12},
}


def peak(kind: str):
    """The peaks of the card `kind` (torch.cuda.get_device_name), or
    None where the table has none."""
    return PEAKS.get(kind)


def bound_s(nbytes: float, ops: float, kind: str):
    """(seconds, "bytes" or "operations"): the least time the card could
    take, the larger of bytes over its bandwidth and operations over its
    integer rate; None where the table has no such card."""
    p = peak(kind)
    if p is None:
        return None
    t_bytes = nbytes / p["bytes_per_s"]
    t_ops = ops / p["int_ops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
