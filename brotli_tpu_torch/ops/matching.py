"""Chunk values, scoring constants, the hashed block matcher and the
fold mirrors.

Torch counterpart of brotli_tpu/ops/matching.py: u32_values(_at), the
hash constants, topk_prev_same_hash, match_lengths_capped, the
hashed-table matcher best_matches_block (_fold_sorted) of the q0/q1
path, and the fold's plain tensor-op forms (the "mirrors"):
best_matches_packed (_fold_sorted_packed), best_matches_fused
(_fold_fused), best_matches_exact, best_matches_exact8 and
best_matches_exact9.  The mirrors run on the input's device, CUDA or
CPU, as torch ops alone: no kernel of this package.  best_matches_exact,
_exact8 and _exact9 give the bits of ops/fold_cuda.py's tier wrappers
(best_matches_exact_p, ...) and are written apart from them, so each
checks the other.  torch's uint32 has no shifts or arithmetic on the
CPU, so a chunk value is carried in int64 (0 <= v < 2^32); `as_i32`
hands it to a kernel, or to a mirror's sort, as the int32 with the same
bits.
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


# ---------------------------------------------------------------------------
# The fold mirrors: the fold as plain tensor ops
# ---------------------------------------------------------------------------

_NO_POS = -(1 << 30)    # the pad of sorted positions: its dist > any window
_SIGN = -(1 << 31)      # int32 bit pattern ^ _SIGN: signed order = unsigned


def _check_packing(rounds: int, len_shift: int) -> None:
    if 4 * rounds >= (1 << (31 - len_shift)):
        raise ValueError("length cap overflows the int32 packing")


def _shift_in(x: torch.Tensor, j: int) -> torch.Tensor:
    """y[i] = x[i - j], the first j zero (a concatenation, as the JAX
    form's, so the neighbour never wraps round)."""
    n = x.shape[0]
    return torch.cat([x.new_zeros(min(j, n)), x[:max(n - j, 0)]])


def _padded(x: torch.Tensor, left: int, right: int = 0,
            fill: int = 0) -> torch.Tensor:
    """x with `left` and `right` copies of fill around it (jnp.pad)."""
    return torch.cat([x.new_full((left,), fill), x,
                      x.new_full((right,), fill)])


def _unsort(pos_s: torch.Tensor, x_s: torch.Tensor) -> torch.Tensor:
    """Sorted space -> position space: out[pos_s[i]] = x_s[i]; pos_s
    is a permutation, so every word is written once."""
    return torch.empty_like(x_s).index_copy_(0, pos_s.long(), x_s)


def _score(ml: torch.Tensor, dist: torch.Tensor, lbs: int) -> torch.Tensor:
    """lbs * len - 30 * floor(log2 dist) where len > 0, else 0."""
    logd = floor_log2(torch.clamp(dist, min=1))
    return torch.where(ml > 0, lbs * ml - DISTANCE_BIT_PENALTY * logd, 0)


def _chain(total, alive, pairs):
    """The compare rounds: each (value, neighbour's value) pair adds
    its equal low bytes while every earlier round matched all 4."""
    for a, b in pairs:
        m = ctz_bytes(a ^ b)
        total = total + torch.where(alive, m, 0)
        alive = alive & (m == 4)
    return total


def _fold_sorted_packed(h: torch.Tensor, k: int, vs: list,
                        window_size: int, lbs: int, best,
                        min_pos: int = 0):
    """_fold_sorted carrying (score << 6 | len) and dist as two int32
    words: after a stable sort by the hash h, a position's k most
    recent same-hash predecessors are its k left neighbours, compared
    through concatenated shifts of the sorted chunk values vs (int64
    u32).  Merged into best = (score << 6 | len, dist) where the packed
    word is greater."""
    n = h.shape[0]
    dev = h.device
    order = torch.argsort(h, stable=True)
    h_s = h[order]
    pos_s = order.to(torch.int32)
    vs_s = [as_i32(v)[order] for v in vs]
    limit_s = n - pos_s
    s_sl = torch.zeros(n, dtype=torch.int32, device=dev)
    s_dist = s_sl
    for j in range(1, k + 1):
        same = torch.zeros(n, dtype=torch.bool, device=dev)
        same[j:] = h_s[j:] == h_s[:max(n - j, 0)]
        cand = _shift_in(pos_s, j)
        dist = pos_s - cand
        total = _chain(torch.zeros_like(pos_s), same,
                       [(v, _shift_in(v, j)) for v in vs_s])
        ml = torch.minimum(total, limit_s)
        valid = same & (dist <= window_size) & (ml >= 4) \
            & (cand >= min_pos)
        ml = torch.where(valid, ml, 0)
        sc = _score(ml, dist, lbs)
        sl = torch.where(valid, (sc << 6) | ml, 0)
        upd = sl > s_sl
        s_sl = torch.where(upd, sl, s_sl)
        s_dist = torch.where(upd, dist, s_dist)
    best_sl, best_dist = best
    p_sl, p_dist = _unsort(pos_s, s_sl), _unsort(pos_s, s_dist)
    upd = p_sl > best_sl
    return (torch.where(upd, p_sl, best_sl),
            torch.where(upd, p_dist, best_dist))


def best_matches_packed(data: torch.Tensor, window_size: int, k: int = 16,
                        k8: int = 8, rounds: int = 4,
                        literal_byte_score: int = 540, min_pos: int = 0):
    """Semi-packed matcher of a uint8 tensor: int32 (score << 6 | len)
    and int32 dist a position, lengths capped at 4 * rounds; the
    17-bit h4 table (k candidates), then the 18-bit h8 table (k8; 0
    skips it)."""
    n = data.shape[0]
    v4 = u32_values(data)
    vs = [v4] + [u32_values_at(data, 4 * r) for r in range(1, rounds)]
    lbs = literal_byte_score // 4
    zero = torch.zeros(n, dtype=torch.int32, device=data.device)
    best = (zero, zero)
    h4 = mul32(v4, HASH_MUL32) >> (32 - 17)
    best = _fold_sorted_packed(h4, k, vs, window_size, lbs, best, min_pos)
    if k8 > 0:
        h8 = (mul32(v4, HASH_MUL32) ^ mul32(vs[1], HASH_MUL32B)) \
            >> (32 - 18)
        best = _fold_sorted_packed(h8, k8, vs, window_size, lbs, best,
                                   min_pos)
    return best


def _fold_fused(h: torch.Tensor, k: int, vs: list, window_size: int,
                lbs: int, best_packed, min_pos: int = 0,
                len_shift: int = 26, base_len: int = 0,
                require_full: bool = False):
    """One table's fold: a stable sort by the int32 key h carrying the
    positions and the chunk values vs (int64 u32), then a stencil over
    the k left neighbours in sorted order, read as slices of arrays
    padded once (keys and values with 0, positions with _NO_POS, so a
    pad's dist exceeds the window), and one scatter of the packed
    (len << len_shift | dist) back to position space.  base_len: bytes
    that key equality attests (the content-keyed folds); require_full:
    only a match of every value counts.  Scores at or under
    MIN_SCORE_DELTA are dropped.  Returns (packed, score) in position
    space, merged into best_packed = (packed, score) where the score is
    greater."""
    n = h.shape[0]
    dev = h.device
    h_s, order = torch.sort(h, stable=True)
    pos_s = order.to(torch.int32)
    vs_s = [as_i32(v)[order] for v in vs]
    hp = _padded(h_s, k)
    pp = _padded(pos_s, k, fill=_NO_POS)
    vps = [_padded(v, k) for v in vs_s]
    limit_s = n - pos_s
    s_score = torch.zeros(n, dtype=torch.int32, device=dev)
    s_packed = s_score
    full_len = base_len + 4 * len(vs)
    for j in range(1, k + 1):
        a = k - j
        same = hp[a:a + n] == h_s
        cand = pp[a:a + n]
        dist = pos_s - cand
        total = _chain(torch.where(same, base_len, 0).to(torch.int32),
                       same, [(v, vp[a:a + n])
                              for v, vp in zip(vs_s, vps)])
        ml = torch.minimum(total, limit_s)
        valid = same & (dist <= window_size) & (ml >= 4) \
            & (cand >= min_pos)
        if require_full:
            valid = valid & (total == full_len)
        ml = torch.where(valid, ml, 0)
        sc = _score(ml, dist, lbs)
        upd = sc > s_score
        s_score = torch.where(upd, sc, s_score)
        s_packed = torch.where(upd, (ml << len_shift) | dist, s_packed)
    gate = s_score > MIN_SCORE_DELTA
    p_packed = _unsort(pos_s, torch.where(gate, s_packed, 0))
    p_score = _unsort(pos_s, torch.where(gate, s_score, 0))
    if best_packed is None:
        return p_packed, p_score
    prev_packed, prev_score = best_packed
    upd = p_score > prev_score
    return (torch.where(upd, p_packed, prev_packed),
            torch.where(upd, p_score, prev_score))


def best_matches_fused(data: torch.Tensor, window_size: int, k: int = 16,
                       k8: int = 8, rounds: int = 4,
                       literal_byte_score: int = 540, min_pos: int = 0,
                       len_shift: int = 26) -> torch.Tensor:
    """Packed int32 (len << len_shift | dist) a position, 0 where no
    candidate passes the score gate: the 17-bit h4 table's fold (k),
    then the 18-bit h8 table's (k8; 0 skips it); lengths cap at
    4 * rounds."""
    _check_packing(rounds, len_shift)
    v4 = u32_values(data)
    vs = [v4] + [u32_values_at(data, 4 * r) for r in range(1, rounds)]
    lbs = literal_byte_score // 4
    h4 = (mul32(v4, HASH_MUL32) >> (32 - 17)).to(torch.int32)
    best = _fold_fused(h4, k, vs, window_size, lbs, None, min_pos,
                       len_shift)
    if k8 > 0:
        h8 = ((mul32(v4, HASH_MUL32) ^ mul32(vs[1], HASH_MUL32B))
              >> (32 - 18)).to(torch.int32)
        best = _fold_fused(h8, k8, vs, window_size, lbs, best, min_pos,
                           len_shift)
    return best[0]


def best_matches_exact(data: torch.Tensor, window_size: int, k: int = 16,
                       k8: int = 0, rounds: int = 2,
                       literal_byte_score: int = 540, min_pos: int = 0,
                       len_shift: int = 26) -> torch.Tensor:
    """Content-keyed matcher: the fold keyed by int32(v0) itself (the
    4 bytes attested by the key, the tail values up to 4 * rounds),
    then, with k8 > 0, a fold keyed by the full 32-bit hash of the
    first 8 bytes carrying every value.  Packed int32 as
    best_matches_fused."""
    _check_packing(rounds, len_shift)
    v4 = u32_values(data)
    vs = [v4] + [u32_values_at(data, 4 * r) for r in range(1, rounds)]
    lbs = literal_byte_score // 4
    best = _fold_fused(as_i32(v4), k, vs[1:], window_size, lbs, None,
                       min_pos, len_shift, base_len=4)
    if k8 > 0:
        h8 = as_i32(mul32(v4, HASH_MUL32) ^ mul32(vs[1], HASH_MUL32B))
        best = _fold_fused(h8, k8, vs, window_size, lbs, best, min_pos,
                           len_shift)
    return best[0]


def _order_u32_pair(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """The stable order of rows by unsigned (v0, v1), int32 bit
    patterns: a stable sort by v1, then a stable sort by v0 (rows of
    equal keys keep position order)."""
    o1 = torch.argsort(v1 ^ _SIGN, stable=True)
    return o1[torch.argsort((v0 ^ _SIGN)[o1], stable=True)]


def best_matches_exact8(data: torch.Tensor, window_size: int, k: int = 16,
                        rounds: int = 4, literal_byte_score: int = 540,
                        min_pos: int = 0, len_shift: int = 26,
                        _with_score: bool = False):
    """One stable sort by unsigned (v0, v1) for both tables: in an exact
    8-byte group the k left neighbours are the k most recent 8-byte
    matches; at a group's edge, neighbours of equal v0 and other v1
    give 4-7 byte matches in (v1, pos) order, so the k // 2 right
    neighbours are scanned too and a candidate needs dist > 0.  Packed
    int32 as best_matches_fused; _with_score adds the score."""
    _check_packing(rounds, len_shift)
    n = data.shape[0]
    v = [as_i32(u32_values_at(data, 4 * r)) for r in range(max(rounds, 2))]
    lbs = literal_byte_score // 4
    order = _order_u32_pair(v[0], v[1])
    v0s, v1s = v[0][order], v[1][order]
    pos_s = order.to(torch.int32)
    vs_s = [x[order] for x in v[2:rounds]]
    p0, p1 = _padded(v0s, k, k), _padded(v1s, k, k)
    pp = _padded(pos_s, k, k, _NO_POS)
    vps = [_padded(x, k, k) for x in vs_s]
    limit_s = n - pos_s
    s_score = torch.zeros(n, dtype=torch.int32, device=data.device)
    s_packed = s_score
    for j in list(range(1, k + 1)) + [-j for j in range(1, k // 2 + 1)]:
        a = k - j
        same4 = p0[a:a + n] == v0s
        x1 = v1s ^ p1[a:a + n]
        cand = pp[a:a + n]
        dist = pos_s - cand
        # 4 + the equal low bytes of v1 where v0 matches; the tail
        # rounds only where v1 matches too
        total = _chain(torch.where(same4, 4 + ctz_bytes(x1), 0),
                       same4 & (x1 == 0),
                       [(x, xp[a:a + n]) for x, xp in zip(vs_s, vps)])
        ml = torch.minimum(total, limit_s)
        valid = same4 & (dist > 0) & (dist <= window_size) & (ml >= 4) \
            & (cand >= min_pos)
        ml = torch.where(valid, ml, 0)
        sc = _score(ml, dist, lbs)
        upd = sc > s_score
        s_score = torch.where(upd, sc, s_score)
        s_packed = torch.where(upd, (ml << len_shift) | dist, s_packed)
    gate = s_score > MIN_SCORE_DELTA
    p_packed = _unsort(pos_s, torch.where(gate, s_packed, 0))
    if not _with_score:
        return p_packed
    return p_packed, _unsort(pos_s, torch.where(gate, s_score, 0))


def best_matches_exact9(data: torch.Tensor, window_size: int, k: int = 16,
                        k_short: int = 16, rounds: int = 4,
                        literal_byte_score: int = 540, min_pos: int = 0,
                        len_shift: int = 26) -> torch.Tensor:
    """The q9 tier's matcher: best_matches_exact8 with its score,
    merged with a short fold keyed by int32(v0) with the one tail value
    v1 (exact 4-byte recency, lengths capped at 8, base_len 4) where
    its score is greater."""
    best = best_matches_exact8(data, window_size, k=k, rounds=rounds,
                               literal_byte_score=literal_byte_score,
                               min_pos=min_pos, len_shift=len_shift,
                               _with_score=True)
    best = _fold_fused(as_i32(u32_values(data)), k_short,
                       [u32_values_at(data, 4)], window_size,
                       literal_byte_score // 4, best, min_pos, len_shift,
                       base_len=4)
    return best[0]
