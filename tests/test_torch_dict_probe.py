"""The static-dictionary probe of compress_gpu (ops/dict_probe_cuda.py)
against the JAX package's static_dict.add_dictionary_matches on the
CPU.

The plain version of the card's probe, then the host merge, must give
exactly the five per-position arrays (length, distance, score, the
dictionary flag, the wire length) that brotli_tpu's
add_dictionary_matches gives for the same region, dictionary prefix and window matches: on
dictionary-dense English text, a sample of the bulk mix, random bytes,
inputs of 0-40 bytes, regions with and without a dictionary prefix,
words cut by the region's end, and a bucket whose two words both match
with equal scores.
"""

import os

import numpy as np
import pytest
import torch

from brotli_tpu.encode import static_dict as SD
from brotli_tpu_torch.ops import dict_probe_cuda as DP
from brotli_tpu_torch.research.corpus import make_corpus
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "SURVEY.md"), "rb") as _f:
    SURVEY = _f.read()


def _window_matches(real: int, seed: int):
    """Window matches as the fold and the extension leave them: no match
    at about half the positions, else a length of 4-40 at a distance up
    to 2^22, with compress_gpu's score (negative where the distance is
    long for the length)."""
    rng = np.random.default_rng(seed)
    bl = rng.integers(4, 41, real).astype(np.int64)
    bl[rng.random(real) < 0.5] = 0
    bd = np.where(bl > 0, rng.integers(1, 1 << 22, real), 0).astype(np.int64)
    with np.errstate(divide="ignore"):
        bsc = np.where(bl > 0, 135 * bl - 30 * np.floor(
            np.log2(np.maximum(bd, 2))).astype(np.int64), 0)
    return bl, bd, bsc


def _reference(region, dlen, window_size, bl, bd, bsc):
    n = len(region)
    arrs = [np.zeros(n, np.int64) for _ in range(3)] + [
        np.zeros(n, bool), np.zeros(n, np.int64)]
    for a, w in zip(arrs, (bl, bd, bsc, None, bl)):
        if w is not None:
            a[dlen:] = w
    SD.add_dictionary_matches(region, dlen, window_size, 135, *arrs)
    return [a[dlen:] for a in arrs]


def _probed(region, dlen, window_size, bl, bd, bsc, halo_pad=3, tail=5):
    """The region laid in a row as compress_gpu lays it (dlen bytes of
    prefix before the halo's end, zeros before them and after the span),
    probed by the plain version and merged."""
    real = len(region) - dlen
    halo = dlen + halo_pad
    row = np.zeros(halo + real + tail, np.uint8)
    row[halo - dlen:halo + real] = region
    out = DP.dict_probe(torch.from_numpy(row), halo, real, halo - dlen,
                        window_size).numpy()
    cand = _assert_layout(out, real, real + tail)
    bl, bd, bsc = bl.copy(), bd.copy(), bsc.copy()
    isdict, wire, won = DP.merge_candidates(out, bl, bd, bsc)
    assert won == int(isdict.sum()) <= cand <= real
    return [bl, bd, bsc, isdict, wire], cand, won


def _assert_layout(out, real, span):
    """Each block of THREADS slots holds its candidates first, in
    position order and inside the block; the counts follow the span,
    and candidates() reads them all.  Returns the number of
    candidates."""
    ctas = -(-span // DP.THREADS)
    assert out.shape == (span + ctas,)
    counts = out[span:]
    for c in range(ctas):
        slots = out[c * DP.THREADS:min(span, (c + 1) * DP.THREADS)]
        n = int(counts[c])
        pos = slots[:n] >> DP.POS_SHIFT
        assert 0 <= n <= len(slots) and (slots[:n] >= 0).all()
        assert (np.diff(pos) > 0).all()
        assert ((pos // DP.THREADS == c) & (pos < real)).all()
    got_counts, words = DP.candidates(out)
    assert np.array_equal(got_counts, counts)
    assert np.array_equal(words, np.concatenate(
        [out[c * DP.THREADS:c * DP.THREADS + int(counts[c])]
         for c in range(ctas)]))
    return len(words)


def _check(data: bytes, dlen: int, window_size: int, seed: int):
    region = np.frombuffer(data, np.uint8)
    real = len(region) - dlen
    w = _window_matches(real, seed)
    got, cand, won = _probed(region, dlen, window_size, *w)
    want = _reference(region, dlen, window_size, *w)
    for name, g, r in zip(("len", "dist", "score", "isdict", "wire"),
                          got, want):
        assert g.dtype == r.dtype and np.array_equal(g, r), name
    return cand, won


def _bulk(off: int, n: int) -> bytes:
    return _bulk_corpus()[off:off + n]


_BULK = []


def _bulk_corpus() -> bytes:
    if not _BULK:
        _BULK.append(make_corpus(1, seed=19))
    return _BULK[0]


@pytest.mark.parametrize("dlen", [0, 4096])
@pytest.mark.parametrize("kind", ["survey", "bulk_text", "bulk_words",
                                  "bulk_records", "bulk_binary", "random"])
def test_probe_and_merge_equal_add_dictionary_matches(kind, dlen):
    n = 24_000
    data = {"survey": lambda: SURVEY[10_000:10_000 + n],
            "bulk_text": lambda: _bulk(10_000, n),
            "bulk_words": lambda: _bulk(300_000, n),
            "bulk_records": lambda: _bulk(600_000, n),
            "bulk_binary": lambda: _bulk(900_000, n),
            "random": lambda: np.random.default_rng(5).integers(
                0, 256, n, np.uint8).tobytes()}[kind]()
    cand, won = _check(data, dlen, window_size=(1 << 18) - 16, seed=dlen)
    if kind == "survey":
        # dictionary-dense: the dictionary takes many positions
        assert won > (n - dlen) // 50 and cand > won


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 9, 17, 28, 40])
def test_short_inputs(n):
    data = SURVEY[1000:1000 + n]
    _check(data, 0, window_size=(1 << 10) - 16, seed=n)


@pytest.mark.parametrize("dlen", [1, 37, 4000])
def test_prefix_then_short_span(dlen):
    """A dictionary prefix of dlen bytes before a span of 30: distances
    count from the region's start, capped at the window."""
    data = SURVEY[5000:5000 + dlen + 30]
    _check(data, dlen, window_size=(1 << 10) - 16, seed=dlen)


def _words(length: int) -> list:
    wb, wl, _, _, _ = SD.dict_index()
    return [bytes(wb[e, :length]) for e in np.flatnonzero(wl == length)]


@pytest.mark.parametrize("cut", [0, 1, 2, 5, 9])
def test_words_cut_by_the_regions_end(cut):
    """Regions ending inside a dictionary word, `cut` bytes short of its
    end: the match is clamped to the bytes left, and taken where an
    OmitLast transform of that length exists."""
    words = [w for w in _words(12) if b" " not in w][:40]
    data = b"".join(b" " + w for w in words[:-1]) + b" " + \
        words[-1][:12 - cut]
    cand, won = _check(data, 0, window_size=(1 << 16) - 16, seed=cut)
    assert won >= 30


def _tie():
    """A bucket whose slot-0 word is a prefix of its slot-1 word, and a
    position where both match, slot 1 through an OmitLast transform, at
    distances of one binary length: two candidates of one score.
    Returns (data, pos, window_size, (len, dist) of slot 0's candidate,
    the two scores)."""
    wb, wl, widx, table, size_bits = SD.dict_index()
    omit_ids = SD.omit_last_transform_ids()
    for b in np.flatnonzero((table >= 0).all(1)):
        e0, e1 = table[b]
        l0, l1 = int(wl[e0]), int(wl[e1])
        omit = l1 - l0
        if not 0 < omit <= 9 or omit_ids[omit] < 0 \
                or bytes(wb[e1, :l0]) != bytes(wb[e0, :l0]):
            continue
        d0 = int(widx[e0])
        d1 = (int(omit_ids[omit]) << int(size_bits[l1])) + int(widx[e1])
        if d1 <= d0:
            continue
        k = (d1 - d0).bit_length()
        base = (1 << k) - d0          # base + d0 and base + d1 share a log2
        scores = [135 * l0 - 30 * int(np.log2(base + d)) for d in (d0, d1)]
        if scores[0] <= 0:
            continue
        stop = b"\x00" if wb[e1, l0] != 0 else b"\x01"
        pos = base - 1
        data = bytes(pos) + bytes(wb[e0, :l0]) + stop
        return data, pos, 1 << (k + 1), (l0, base + d0), scores
    raise AssertionError("no bucket with a prefix pair")


def test_tied_slots_keep_slot_zero():
    """Both slots of the bucket at pos score alike: the merge keeps slot
    0's word, the shorter one, at its identity distance (the sequential
    loop replaces only on a strictly greater score)."""
    data, pos, window, (l0, d0), scores = _tie()
    assert scores[0] == scores[1]
    region = np.frombuffer(data, np.uint8)
    zeros = (np.zeros(len(region), np.int64),) * 3
    got, cand, won = _probed(region, 0, window, *zeros)
    assert got[3][pos] and (got[0][pos], got[1][pos], got[2][pos],
                            got[4][pos]) == (l0, d0, scores[0], l0)
    _check(data, 0, window, seed=1)


def test_merge_keeps_negative_scores():
    """A candidate whose score is negative replaces a window match whose
    score is lower still, and not one that is higher."""
    dist = (1 << 24) + 5            # floor(log2) 24: 135 * 4 - 720 = -180
    e = 7 << DP.POS_SHIFT | 6 << DP.WIRE_SHIFT | 4 << DP.LEN_SHIFT | dist
    out = np.full(10 + 1, DP.NONE, np.int64)
    out[0], out[10] = e, 1
    for window_score, takes in [(-181, True), (-180, False), (0, False)]:
        bl = np.full(10, 3, np.int64)
        bd = np.full(10, 1 << 24, np.int64)
        bsc = np.full(10, window_score, np.int64)
        isdict, wire, won = DP.merge_candidates(out, bl, bd, bsc)
        assert (won, bool(isdict[7])) == (int(takes), takes)
        if takes:
            assert (bl[7], bd[7], bsc[7], wire[7]) == (4, dist, -180, 6)
        assert (bl[:7] == 3).all() and (wire[:7] == 3).all()


def test_probe_rejects_what_it_cannot_take():
    row = torch.zeros(100, dtype=torch.uint8)
    for args in [(row.int(), 10, 5, 0, 100), (row, 100, 0, 0, 100),
                 (row, 10, 91, 0, 100), (row, 10, 5, 11, 100),
                 (row, 10, 5, 0, 1 << 25)]:
        with pytest.raises(ValueError):
            DP.dict_probe(*args)
    assert DP.probe_plan(1) == {"threads": 256, "ctas": 1}
    assert DP.probe_plan(524_288)["ctas"] == 2048
