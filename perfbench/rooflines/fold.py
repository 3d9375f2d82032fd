"""Bytes and operations of one launch of the fold (csrc/fold.cu), from
its shapes alone.

The fold takes n sorted rows of int32 operands, `n_keys` key words, the
position and `n_pay` payload words a row, and writes two int32 outputs
a row (packed match, score).  Each row is held against the next
`k_fwd` and the previous `k_back` rows.  Counted:

  bytes       every operand read once and every output written once:
              4 * n * (n_keys + 1 + n_pay) + 8 * n
  operations  for each (row, offset) pair, one compare per key word and
              one select of the better candidate: n * (k_fwd + k_back)
              * (n_keys + 1)

Neither count depends on where the kernel's early exits stop a row, so
a kernel that does less work than the pairs it is handed reads a
higher share, and one that reads an operand twice a lower one.
"""

from __future__ import annotations


def fold_bytes(n: int, n_keys: int, n_pay: int) -> int:
    return 4 * n * (n_keys + 1 + n_pay) + 8 * n


def fold_ops(n: int, n_keys: int, k_fwd: int, k_back: int) -> int:
    return n * (k_fwd + k_back) * (n_keys + 1)
