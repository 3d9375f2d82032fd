"""Block-local parallel parse: pointer doubling over match jumps.

Counterpart of brotli_tpu/ops/parse.py.  The greedy LZ77 walk is
sequential; here it is a reachability problem solved in O(log B)
tensor steps per sub-block: next[i] = i + copy_len[i] (or +1 for a
literal), and the positions the chain from the sub-block start visits
are marked by jump-table doubling with a scatter-max.  Every sub-block
parses independently; matches may reference anywhere back, only the
parse commitment is local.
"""

from __future__ import annotations

import torch

from .matching import MIN_SCORE_DELTA


def committed_parse(best_len: torch.Tensor, best_score: torch.Tensor,
                    sub_block: int = 4096):
    """visited[i] = True if the block-local greedy chain lands on i.

    best_len/best_score: int32 [n]; n must be a multiple of sub_block.
    Matches are truncated at sub-block ends.  Returns (visited bool,
    take int32): the parse takes, at each visited i, a copy of take[i]
    (0 = literal)."""
    n = best_len.shape[0]
    if n % sub_block:
        raise ValueError(f"committed_parse: {n} positions are not a "
                         f"multiple of the sub-block {sub_block}")
    nb = n // sub_block
    dev = best_len.device
    pos_in = torch.arange(n, dtype=torch.int32, device=dev) % sub_block
    room = sub_block - pos_in
    take = torch.where(best_score > MIN_SCORE_DELTA,
                       torch.minimum(best_len, room), 0)
    take = torch.where(take >= 2, take, 0)
    step = torch.clamp(take, min=1)

    # local jump targets; the sentinel column sub_block absorbs every
    # jump past the end
    nxt = torch.clamp((pos_in + step).reshape(nb, sub_block),
                      max=sub_block).long()
    sentinel = torch.full((nb, 1), sub_block, dtype=torch.int64,
                          device=dev)
    jump = torch.cat([nxt, sentinel], dim=1)
    # int32 marks: scatter_reduce takes no bool
    visited = torch.zeros((nb, sub_block + 1), dtype=torch.int32,
                          device=dev)
    visited[:, 0] = 1

    steps = (sub_block - 1).bit_length() + 1   # ceil(log2(sub_block)) + 1
    for _ in range(steps):
        # mark nodes reachable in one more jump-table application
        reached = torch.zeros_like(visited).scatter_reduce(
            1, jump, visited, reduce="amax")
        visited = visited | reached
        # double the jump table
        jump = torch.gather(torch.cat([jump, sentinel], dim=1), 1, jump)

    return visited[:, :sub_block].reshape(n).bool(), take
