"""Chunk values, scoring constants and the hashed block matcher.

Torch counterpart of brotli_tpu/ops/matching.py: u32_values(_at), the
hash constants, topk_prev_same_hash, match_lengths_capped and the
hashed-table matcher best_matches_block (_fold_sorted) of the q0/q1
path.  torch's uint32 has no shifts or arithmetic on the CPU, so a
chunk value is carried in int64 (0 <= v < 2^32); `as_i32` hands it to
a kernel as the int32 with the same bits.
"""

from __future__ import annotations

import torch

HASH_MUL32 = 0x1E35A7BD
HASH_MUL32B = 0x9E3779B1
LEN_CAP = 32                 # 8 rounds x 4 bytes
DISTANCE_BIT_PENALTY = 30
MIN_SCORE_DELTA = 100


def u32_values_at(data: torch.Tensor, offset: int) -> torch.Tensor:
    """LE u32 of bytes [i + offset, i + offset + 4) at every position i
    of a uint8 tensor (tail zero-padded), as int64."""
    n = data.shape[0]
    d = torch.cat([data, data.new_zeros(offset + 4)]).to(torch.int64)
    o = offset
    return (d[o:n + o] | (d[o + 1:n + o + 1] << 8)
            | (d[o + 2:n + o + 2] << 16) | (d[o + 3:n + o + 3] << 24))


def u32_values(data: torch.Tensor) -> torch.Tensor:
    """LE u32 at every byte position (tail zero-padded), as int64."""
    return u32_values_at(data, 0)


def as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 tensors with the same 32 bits."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2^32 for int64 u32 values v, without int64 overflow:
    c is split into 16-bit halves, so each product stays below 2^48."""
    lo = v * (c & 0xFFFF)
    hi = ((v * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def ctz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Trailing zero BYTES of 32-bit words (4 when x == 0), by byte-mask
    compares (torch has no ctz or popcount); int32 bit patterns or int64
    u32 values."""
    i32 = torch.int32
    return (((x & 0xFF) == 0).to(i32) + ((x & 0xFFFF) == 0).to(i32)
            + ((x & 0xFFFFFF) == 0).to(i32) + (x == 0).to(i32))


def floor_log2(d: torch.Tensor) -> torch.Tensor:
    """floor(log2 d) of positive int32 values, exactly: the binary
    exponent of d as a float64 (every int32 is exact there)."""
    return torch.frexp(d.to(torch.float64))[1] - 1


def topk_prev_same_hash(h: torch.Tensor, k: int) -> torch.Tensor:
    """cands[j, i] = (j+1)-th most recent previous position with the
    same hash as position i, or -1 (int32 [k, n]).  One stable sort + k
    shifted compares."""
    n = h.shape[0]
    order = torch.argsort(h, stable=True)
    h_sorted = h[order]
    inv = torch.empty_like(order).index_copy_(
        0, order, torch.arange(n, device=h.device))
    cands = []
    for j in range(1, k + 1):
        same = torch.zeros(n, dtype=torch.bool, device=h.device)
        same[j:] = h_sorted[j:] == h_sorted[:n - j]
        prev = torch.full((n,), -1, dtype=torch.int32, device=h.device)
        prev[j:] = order[:n - j].to(torch.int32)
        cands.append(torch.where(same, prev, -1)[inv])
    return torch.stack(cands)


def match_lengths_capped(v4: torch.Tensor, a: torch.Tensor,
                         b: torch.Tensor, limit: torch.Tensor
                         ) -> torch.Tensor:
    """min(matchlen(a, b), limit, LEN_CAP) via u32 XOR + ctz rounds;
    v4[i] = LE u32 at byte i (u32_values), rounds advance 4 bytes."""
    n4 = v4.shape[0]
    a, b = a.long(), b.long()
    total = torch.zeros(a.shape, dtype=torch.int32, device=v4.device)
    alive = torch.ones(a.shape, dtype=torch.bool, device=v4.device)
    for r in range(LEN_CAP // 4):
        m = ctz_bytes(v4[torch.clamp(a + 4 * r, 0, n4 - 1)]
                      ^ v4[torch.clamp(b + 4 * r, 0, n4 - 1)])
        total = total + torch.where(alive, m, 0)
        alive = alive & (m == 4)
    return torch.minimum(total, limit.to(torch.int32))


def _fold_sorted(h: torch.Tensor, k: int, vs: list, window_size: int,
                 lbs: int, best, min_pos: int = 0):
    """Candidate fold in hash-sorted space: after a stable sort by
    hash, a position's k most recent same-hash predecessors are its k
    left neighbours, so a candidate compare is a shifted-slice compare.
    The length of offset j is the match_rounds chain over the sorted
    chunk values and their shift by j; rows whose neighbour has another
    hash are zeroed afterwards (the round chain of such a row never
    counts in the reference, whose chain starts with alive = same).
    The k offsets' lengths come from one launch of the kernel's fold
    form, which reads the shifted words from va itself."""
    from .match_rounds_cuda import match_rounds_shifted

    n = h.shape[0]
    dev = h.device
    order = torch.argsort(h, stable=True)
    h_s = h[order]
    va = torch.stack([as_i32(v) for v in vs])[:, order]
    pos_s = order.to(torch.int32)
    limit_s = n - pos_s
    s_len = s_dist = s_score = torch.zeros(n, dtype=torch.int32,
                                           device=dev)
    lengths = match_rounds_shifted(va, k)
    for j in range(1, k + 1):
        same = torch.zeros(n, dtype=torch.bool, device=dev)
        same[j:] = h_s[j:] == h_s[:n - j]
        cand = torch.zeros(n, dtype=torch.int32, device=dev)
        cand[j:] = pos_s[:n - j]
        dist = pos_s - cand
        total = torch.where(same, lengths[j - 1], 0)
        ml = torch.minimum(total, limit_s)
        # min_pos masks candidates in a zero-filled context halo
        valid = same & (dist <= window_size) & (ml >= 4) \
            & (cand >= min_pos)
        ml = torch.where(valid, ml, 0)
        logd = floor_log2(torch.clamp(dist, min=1))
        sc = torch.where(ml > 0, lbs * ml - DISTANCE_BIT_PENALTY * logd, 0)
        upd = sc > s_score
        s_len = torch.where(upd, ml, s_len)
        s_dist = torch.where(upd, dist, s_dist)
        s_score = torch.where(upd, sc, s_score)

    # scatter back to position space, keeping the running best
    best_len, best_dist, best_score = best
    p_len = torch.empty_like(s_len).index_copy_(0, order, s_len)
    p_dist = torch.empty_like(s_dist).index_copy_(0, order, s_dist)
    p_score = torch.empty_like(s_score).index_copy_(0, order, s_score)
    upd = p_score > best_score
    return (torch.where(upd, p_len, best_len),
            torch.where(upd, p_dist, best_dist),
            torch.where(upd, p_score, best_score))


def best_matches_block(data: torch.Tensor, window_size: int, k: int = 8,
                       bucket_bits: int = 17, k8: int = 4,
                       bucket_bits8: int = 18,
                       literal_byte_score: int = 540, min_pos: int = 0,
                       rounds: int = LEN_CAP // 4):
    """Per-position best (len, dist, score), int32 each, of a uint8
    tensor: the 4-byte hash table (k candidates) and the 8-byte
    long-match table (k8), lengths capped at 4 * rounds.  min_pos
    excludes candidates below it."""
    n = data.shape[0]
    v4 = u32_values(data)
    vs = [v4] + [u32_values_at(data, 4 * r) for r in range(1, rounds)]
    lbs = literal_byte_score // 4
    zero = torch.zeros(n, dtype=torch.int32, device=data.device)
    best = (zero, zero, zero)
    h4 = mul32(v4, HASH_MUL32) >> (32 - bucket_bits)
    best = _fold_sorted(h4, k, vs, window_size, lbs, best, min_pos)
    if k8 > 0:
        # 8-byte hash from two u32 loads (long-match table)
        h8 = (mul32(v4, HASH_MUL32) ^ mul32(vs[1], HASH_MUL32B)) \
            >> (32 - bucket_bits8)
        best = _fold_sorted(h8, k8, vs, window_size, lbs, best, min_pos)
    return best
