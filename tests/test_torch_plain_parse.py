"""compress_gpu(max_device=True)'s device parse against the benchmark's
plain reference, perfbench/plain_parse.py (a sequential greedy walk in
integers that imports nothing of either package).

committed_parse + _commands_from_parse on seeded lengths, distances and
scores with planted edges (a copy across a seam, a copy of exactly the
room, a score of exactly 100, length 1, distance 0 or 1); the commands
of every span of two seeded corpora from the fold's own outputs on the
CPU (perfbench/card_parse.py, the check the card runs); and the stream
back through the system libbrotlidec.  Tolerance: exact equality.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from . import oracle
from brotli_tpu_torch import compress_gpu, decompress
from brotli_tpu_torch.encode import gpu_path as G
from brotli_tpu_torch.ops import parse
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PERFBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench")


def _load(name):
    """perfbench/<name>.py by path, under its own name (card_parse
    imports plain_parse by name, as the harness's modules import each
    other)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(PERFBENCH, name + ".py"))
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


P = _load("plain_parse")
card_parse = _load("card_parse")

N = 8 * 4096


def _seeded(sub_block, seed):
    """Lengths, distances and scores of N positions, with each edge
    planted at the start of a sub-block of its own (always visited)
    after the sub-block's literals lead up to it."""
    rng = np.random.default_rng(seed)
    bl = np.where(rng.random(N) < 0.4, rng.integers(2, 40, N),
                  rng.integers(0, 4, N)).astype(np.int32)
    bd = rng.integers(0, 1 << 20, N).astype(np.int32)
    sc = np.where(bl >= 2, rng.integers(0, 2000, N),
                  rng.integers(0, 150, N)).astype(np.int32)

    def block(k):
        return (k * 7 + 3) % (N // sub_block) * sub_block

    def lead(b0, at):       # literals from the sub-block's start to `at`
        bl[b0:at], sc[b0:at] = 0, 0

    b0 = block(0)                      # a copy of exactly the room
    bl[b0], sc[b0] = sub_block, 5000
    b0 = block(1)                      # a copy across the seam: cut to 3
    lead(b0, b0 + sub_block - 3)
    bl[b0 + sub_block - 3], sc[b0 + sub_block - 3] = 10, 900
    b0 = block(2)                      # cut to 1 at the seam: a literal
    lead(b0, b0 + sub_block - 1)
    bl[b0 + sub_block - 1], sc[b0 + sub_block - 1] = 5, 900
    b0 = block(3)                      # score exactly 100, then 101
    bl[b0], sc[b0] = 8, 100
    bl[b0 + 1], sc[b0 + 1] = 8, 101
    b0 = block(4)                      # length 1 with a winning score
    bl[b0], sc[b0] = 1, 500
    b0 = block(5)                      # distance 0, then 1
    bl[b0], sc[b0], bd[b0] = 6, 700, 0
    bl[b0 + 6], sc[b0 + 6], bd[b0 + 6] = 3, 400, 1
    return bl, bd, sc


def _port_commands(bl, bd, sc, sub_block, real):
    visited, take = parse.committed_parse(torch.from_numpy(bl),
                                          torch.from_numpy(sc), sub_block)
    ins, cps, dst, _ = G._commands_from_parse(
        visited.numpy(), take.numpy(), bd, real)
    return [tuple(int(v) for v in c) for c in zip(ins, cps, dst)]


@pytest.mark.parametrize("seed", [201, 202])
@pytest.mark.parametrize("sub_block", [64, 4096])
def test_committed_parse_equals_the_plain_walk(sub_block, seed):
    bl, bd, sc = _seeded(sub_block, seed)
    want = P.commands(bl.tolist(), bd.tolist(), N, sub_block,
                      scores=sc.tolist())
    assert _port_commands(bl, bd, sc, sub_block, N) == want
    copies = {c[1] for c in want}
    assert {2, 3}.issubset(copies)     # cut at seams
    assert sub_block in copies         # exactly the room
    assert sum(c[0] + c[1] for c in want) == N


@pytest.mark.parametrize("real", [2 * 4096, 2 * 4096 - 192])
def test_match_parse_dense_cuts_after_the_score(real, monkeypatch):
    """_match_parse_dense on seeded fold outputs equals the plain walk,
    with far 24-byte matches planted 2 bytes before the span's end: cut
    to 2 after the score they are copies, scored at 2 they would not
    be."""
    rng = np.random.default_rng(real)
    n = 2 * 4096
    bl = np.where(rng.random(n) < 0.5, rng.integers(4, 25, n), 0)
    bd = rng.integers(1, 1 << 20, n)
    for p in (real - 2, 4096 - 2):
        bl[p], bd[p] = 24, 1000        # 135 * 2 - 30 * 9 = 0 <= 100
        bl[p - 24:p] = 0
    packed = torch.from_numpy((bl << G.LEN_SHIFT | bd).astype(np.int32))
    monkeypatch.setattr(G, "best_matches_exact_p", lambda *a, **k: packed)
    visited, take, dist = G._match_parse_dense(
        torch.zeros(n, dtype=torch.uint8), 0, 1 << 20, 0, k=32, rounds=6,
        real=real)
    ins, cps, dst, _ = G._commands_from_parse(
        visited.numpy(), take.numpy(), dist.numpy(), real)
    got = [tuple(int(v) for v in c) for c in zip(ins, cps, dst)]
    want = P.span_commands(packed.tolist(), real)
    assert got == want
    assert (2, 1000) in {(c[1], c[2]) for c in want}


def test_plain_walk_edges():
    """The walk's rules on one sub-block of 16: a score of exactly 100
    steps a literal, 101 copies; a copy of length 1 is a literal; a
    copy is cut at the seam and at `real`, and dropped under 2."""
    sb = 16
    bl = [8, 8, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 9, 0, 0] + [24] * 16
    sc = [100, 101] + [0] * 7 + [500, 0, 0, 0, 400, 0, 0] + [900] * 16
    bd = list(range(1, 33))
    got = P.commands(bl, bd, 32, sb, scores=sc)
    assert got == [(1, 8, 2), (4, 3, 14), (0, 16, 17)]
    assert P.commands(bl, bd, 20, sb, scores=sc) == [
        (1, 8, 2), (4, 3, 14), (0, 4, 17)]
    assert P.commands(bl, bd, 17, sb, scores=sc) == [
        (1, 8, 2), (4, 3, 14), (1, 0, 1)]
    # scored from length and distance: 135 * 1 - 0 > 100 but length 1
    assert P.score(1, 1) == 135 and P.score(3, 1 << 10) == 105
    assert P.score(0, 5) == 0 and P.score(4, 0) == P.score(4, 1) == 540
    with pytest.raises(ValueError):
        P.commands([0] * 20, [0] * 20, 20, sb)


def _corpus(kind):
    """Two spans of 64 KiB, the second short: zipf words and noisy
    records, ending in random bytes ("random") or in a run of zeros
    that copies would run past the input on ("zeros")."""
    rng = np.random.default_rng(211)
    words = [bytes(rng.integers(97, 123, size=int(rng.integers(2, 9)),
                                dtype=np.uint8)) for _ in range(300)]
    text = b" ".join(words[int(i)] for i in
                     rng.zipf(1.3, size=20000) % len(words))[:50000]
    rec = np.tile(rng.integers(0, 256, 48, dtype=np.uint8), 400)
    rec[rng.integers(0, len(rec), 1500)] = 7
    tail = (rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
            if kind == "random" else bytes(3010))
    return text + rec.tobytes() + tail


SPAN = 1 << 16


@pytest.mark.parametrize("kind", ["random", "zeros"])
@pytest.mark.parametrize("quality", [5, 9])
def test_fold_outputs_parse_as_the_plain_walk(quality, kind):
    """Every span's commands from the fold's real outputs (the CPU fold)
    equal the plain walk over the same outputs; the stream is the
    unpatched call's, its counters the walk's, and it decodes."""
    data = _corpus(kind)
    stats = {}
    out, fig = card_parse.checked_compress(data, quality=quality, span=SPAN,
                                           stats=stats, device="cpu")
    assert out == compress_gpu(data, quality=quality, span=SPAN,
                               max_device=True, device="cpu")
    assert fig["spans"] == 2 and fig["positions"] == len(data)
    assert stats["parse.positions"] == len(data)
    assert stats["parse.copied"] == fig["copied"]
    assert decompress(out) == data


def test_checked_compress_catches_a_wrong_parse(monkeypatch):
    """A parse committed over half sub-blocks cuts copies where the walk
    does not: the check raises at the first span."""
    committed = G.committed_parse
    monkeypatch.setattr(G, "committed_parse",
                        lambda bl, sc, sub: committed(bl, sc, sub // 2))
    with pytest.raises(AssertionError, match="span 0: command"):
        card_parse.checked_compress(_corpus("random"), quality=5, span=SPAN,
                                    device="cpu")


@pytest.mark.parametrize("kind", ["random", "zeros"])
def test_max_device_stream_decodes_through_libbrotlidec(kind):
    if not oracle.available():
        pytest.skip("the system's libbrotlidec is not installed")
    data = _corpus(kind)
    out = compress_gpu(data, quality=5, span=SPAN, max_device=True,
                       device="cpu")
    assert oracle.decompress(out) == data
