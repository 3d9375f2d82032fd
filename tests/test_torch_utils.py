"""The port's utils/ (IR text dump, stream analysis, prior search)
against brotli_tpu.utils, on the CPU.

Every comparison has a tolerance of 0: strings equal, every float
field equal under ==, every array equal element for element and of the
same dtype.  Inputs are seeded (the phrases of tests/test_torch_encoder
.py, stride-4 records, random bytes), the repo's text files that the
port leaves unchanged, and the RFC dictionary; the last three tests
rebuild tests/test_ffi.py's utils scenarios (which read an absent test
corpus) on those inputs, against the port.
"""

import dataclasses
import os

import numpy as np
import pytest

from brotli_tpu.utils import analysis as JA
from brotli_tpu.utils import ir as JI
from brotli_tpu.utils import prior as JP
from brotli_tpu_torch.utils import analysis as TA
from brotli_tpu_torch.utils import ir as TI
from brotli_tpu_torch.utils import prior as TP
from .test_torch_encoder import ROOT, dictionary_slice, phrases
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TEXT_FILES = ["SURVEY.md", "PAPER.md", "SNIPPETS.md", "PAPERS.md"]


def repo_text(n: int) -> bytes:
    """The first n bytes of the repo's text files (unchanged by the
    port), repeated as needed."""
    text = b"".join(open(os.path.join(ROOT, f), "rb").read()
                    for f in TEXT_FILES)
    return (text * (n // len(text) + 1))[:n]


def records(n: int, seed: int = 3) -> bytes:
    """Stride-4 records: a constant byte and a slow counter every 4th
    byte among random ones (tests/test_ffi.py's float-like records)."""
    rec = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
    rec[::4] = 0x3F
    rec[1::4] = (np.arange(len(rec[1::4])) % 7).astype(np.uint8)
    return rec.tobytes()


def random_bytes(n: int, seed: int = 9) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


INPUTS = {
    "text": repo_text(24_000),
    "records": records(16_384),
    "text_then_records": repo_text(16_384) + records(16_384),
    "random": random_bytes(12_000),
    "under_16": b"abcdefghij",
    "under_a_stride": b"abcde",
    "empty": b"",
}


def same(a, b) -> None:
    """a (the JAX package's) equals b (the port's) exactly: containers
    element by element, arrays in dtype and every element, dataclasses
    field by field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        same(dataclasses.asdict(a), dataclasses.asdict(b))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        assert a.shape == b.shape and np.array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        assert type(a) is type(b) and a == b, (a, b)


# ---------------------------------------------------------------------------
# ir: format_ir and dump_ir
# ---------------------------------------------------------------------------

META = {
    "none": {},
    "cm_speed": dict(cm_speed=(4, 1024)),
    "stride_speed": dict(stride_speed=(32, 4096)),
    "both_speeds": dict(cm_speed=(1, 4096), stride_speed=(128, 16384)),
    "prior_bitmask": dict(prior_bitmask=0x0F0F),
    "mix_weight": dict(mix_weight=0.4375),
    "all": dict(cm_speed=(8, 8192), stride_speed=(16, 48),
                prior_bitmask=0xFFDE, mix_weight=0.5),
}


@pytest.mark.parametrize("meta", META)
@pytest.mark.parametrize("quality", [0, 5, 9])
def test_dump_ir_matches_jax(quality, meta):
    data = phrases(12_000, seed=4) + repo_text(8_000)
    got = TI.dump_ir(data, quality=quality, lgwin=18, **META[meta])
    assert got == JI.dump_ir(data, quality=quality, lgwin=18, **META[meta])
    assert got.startswith("prediction lsb6 lcontextmap dcontextmap ")
    kinds = {line.split()[0] for line in got.splitlines()}
    assert kinds >= {"prediction", "insert", "copy"}


@pytest.mark.parametrize("quality", [0, 9, 12])
def test_dump_ir_caps_quality_at_9_and_reads_dictionary_words(quality):
    """Quality above 9 dumps q9's IR; from q4 up the RFC dictionary's
    words appear as dict records (not below: the q0 fragment parser
    takes no dictionary match)."""
    data = dictionary_slice(10_000, 30_000)
    got = TI.dump_ir(data, quality=quality)
    assert got == JI.dump_ir(data, quality=quality)
    assert (got == TI.dump_ir(data, quality=9)) == (quality >= 9)
    has_dict = any(line.startswith("dict ") for line in got.splitlines())
    assert has_dict == (quality >= 4)


def test_dump_ir_empty_input():
    assert TI.dump_ir(b"") == JI.dump_ir(b"") == ""
    assert TI.dump_ir(b"", cm_speed=(4, 1024)) == ""


def _ir_pairs():
    """The same IR records built from each package's classes."""
    def build(m):
        return [
            m.PredictionMode(mode=2, literal_context_map=[0, 1, 1, 2],
                             distance_context_map=[0, 0, 1, 1],
                             cm_speed=(2, 1024), prior_bitmask=0x1,
                             mix_weight=0.25),
            m.PredictionMode(mode=7),
            m.BlockSwitchLiteral(3, 4), m.BlockSwitchCommand(1),
            m.BlockSwitchDistance(2), m.Copy(num_bytes=9, distance=300),
            m.Dict(word_size=6, word_id=12, transform=9, final_size=7),
            m.Dict(word_size=4, word_id=0, transform=0, final_size=4),
            m.Literal(b"abc\x00\xff"), m.Literal(b"x", high_entropy=True),
            m.Literal(b""),
        ]
    return build(JI), build(TI)


def test_format_ir_every_record_matches_jax():
    want, have = _ir_pairs()
    assert TI.format_ir(have) == JI.format_ir(want)
    assert TI.format_ir([]) == JI.format_ir([]) == "\n"
    assert TI.MODE_NAMES == JI.MODE_NAMES


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prior", [0, 1])
@pytest.mark.parametrize("stride_quality", [0, 1, 2])
@pytest.mark.parametrize("name", INPUTS)
def test_analyze_matches_jax(name, stride_quality, prior):
    data = INPUTS[name]
    same(JA.analyze(data, stride_quality, prior),
         TA.analyze(data, stride_quality, prior))


def test_analyze_samples_the_first_mib_over_a_mib(monkeypatch):
    """Over 1 MiB the scorers read the first MiB, whatever the stride
    quality (the speed search, held to the JAX package's elsewhere, is
    stubbed in both packages to keep this test short; it logs the
    length it is given)."""
    seen = []

    def speeds(sample):
        seen.append(len(sample))
        return (16, 8192), (16, 8192)

    monkeypatch.setattr(TA, "detect_speeds", speeds)
    monkeypatch.setattr(JA, "detect_speeds", speeds)
    data = repo_text(1 << 20) + records(4096)
    got = TA.analyze(data, 1, 1)
    same(JA.analyze(data, 1, 1), got)
    assert seen == [1 << 20, 1 << 20]


@pytest.mark.parametrize("name", INPUTS)
def test_stride_costs_and_speeds_match_jax(name):
    arr = np.frombuffer(INPUTS[name], np.uint8)
    same(JA.stride_entropy_costs(arr), TA.stride_entropy_costs(arr))
    same(JA.detect_speeds(arr), TA.detect_speeds(arr))
    for inc, cap in JA.CANDIDATE_SPEEDS:
        for nibble in (True, False):
            same(JA.adaptive_cost(arr, inc, cap, nibble),
                 TA.adaptive_cost(arr, inc, cap, nibble))


@pytest.mark.parametrize("levels", [1, 4])
@pytest.mark.parametrize("name", ["text", "records", "text_then_records",
                                  "random", "under_16"])
def test_entropy_pyramid_matches_jax(name, levels):
    arr = np.frombuffer(INPUTS[name], np.uint8)
    same(JA.entropy_pyramid(arr, levels), TA.entropy_pyramid(arr, levels))
    same(JA.pyramid_stride_regions(arr, levels),
         TA.pyramid_stride_regions(arr, levels))


@pytest.mark.parametrize("num_types", [1, 3])
@pytest.mark.parametrize("name", ["text_then_records", "random",
                                  "under_a_stride"])
def test_stride_eval_per_block_matches_jax(name, num_types):
    lits = np.frombuffer(INPUTS[name], np.uint8)
    types = (np.arange(len(lits)) * num_types // max(1, len(lits))) \
        .astype(np.int64)
    same(JA.stride_eval_per_block(lits, types, num_types),
         TA.stride_eval_per_block(lits, types, num_types))


@pytest.mark.parametrize("name", ["text", "records", "random"])
def test_detect_prior_matches_jax(name):
    arr = np.frombuffer(INPUTS[name], np.uint8)
    costs = JA.stride_entropy_costs(arr)
    for best in range(1, 9):
        for shift in (0.0, 0.04, 0.2, 0.5):
            c = [costs[0] + shift] + costs[1:]
            assert TA.detect_prior(arr, best, c) == \
                JA.detect_prior(arr, best, c)


# ---------------------------------------------------------------------------
# prior
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("limit", [1 << 20, 4096])
@pytest.mark.parametrize("name", INPUTS)
def test_prior_eval_matches_jax(name, limit):
    data = INPUTS[name]
    same(JP.prior_eval(data, limit), TP.prior_eval(data, limit))


@pytest.mark.parametrize("name", ["text", "records", "random", "empty"])
def test_find_speed_matches_jax(name):
    lits = np.frombuffer(INPUTS[name], np.uint8).astype(np.int64)
    ctx = np.concatenate([[0], lits[:-1] >> 4]) if len(lits) else \
        np.zeros(0, np.int64)
    same(JP.find_speed(lits, ctx, 16), TP.find_speed(lits, ctx, 16))
    same(JP._nibble_stream(lits), TP._nibble_stream(lits))
    for inc, cap in [(0, 1024), (16, 48), (512, 16384)]:
        sym = JP._nibble_stream(lits)
        c2 = np.repeat(ctx, 2)
        same(JP._ctx_adaptive_cost(c2, sym, 16, inc, cap),
             TP._ctx_adaptive_cost(c2, sym, 16, inc, cap))


def test_weights_update_sequence_matches_jax():
    """Q16 weights truncated by int() at every step, from the same
    probabilities: the weight and mix equal after each update."""
    rng = np.random.default_rng(17)
    pairs = rng.random((400, 2)).tolist() + [[0.0, 0.0], [1.0, 0.0],
                                             [0.0, 1.0], [1e-9, 0.9]]
    for w0, lr in [(0.5, 0.02), (0.1, 0.3), (0.99, 0.001)]:
        a, b = JP.Weights(w0, lr), TP.Weights(w0, lr)
        assert (a.w, a.lr) == (b.w, b.lr)
        for p0, p1 in pairs:
            a.update(p0, p1)
            b.update(p0, p1)
            assert a.w == b.w
            assert a.mix(p0, p1) == b.mix(p0, p1)
    assert TP.PRIOR_NAMES == JP.PRIOR_NAMES
    assert TP.CANDIDATE_SPEEDS == JP.CANDIDATE_SPEEDS


# ---------------------------------------------------------------------------
# tests/test_ffi.py's utils scenarios, on in-repo inputs
# ---------------------------------------------------------------------------

def test_prior_eval_and_speeds():
    """Full prior/CM-speed search: text prefers the CM family; speeds
    are from the candidate table; the mixer moves toward the better
    model."""
    rep = TP.prior_eval(repo_text(200_000))
    assert len(rep.per_context) == 16
    assert rep.cm_speed in TP.CANDIDATE_SPEEDS
    assert rep.stride_speed in TP.CANDIDATE_SPEEDS
    assert set(rep.costs) >= {"CM", "SLOW_CM", "FAST_CM", "STRIDE1",
                              "ADV"}
    assert rep.costs["CM"] <= rep.costs["STRIDE4"]
    m = TP.Weights()
    for _ in range(200):
        m.update(0.9, 0.1)
    assert m.w / 65536.0 > 0.6


def test_entropy_pyramid_regional_strides():
    """A file that switches from text to stride-4 records mid-way gets
    per-region stride picks that the flat scorer blurs together."""
    text = np.frombuffer(repo_text(32_768), np.uint8)
    data = np.concatenate([text, np.frombuffer(records(32_768), np.uint8)])
    pyr = TA.entropy_pyramid(data, levels=3)
    assert 0 in pyr and 3 in pyr
    assert pyr[3].shape == (8, 8)
    region_len, strides = TA.pyramid_stride_regions(data, levels=3)
    assert region_len == len(data) // 8
    assert strides[0] == 1
    assert strides[-1] in (4, 8)
    rep = TA.analyze(data.tobytes(), stride_detection_quality=2)
    assert rep.region_strides is not None
    assert len(rep.region_strides) >= 8


def test_stride_eval_per_block_type():
    """Each literal block type gets its own stride winner."""
    rng = np.random.default_rng(5)
    text = np.frombuffer(b"abcdefgh" * 2048, np.uint8).copy()
    rec = rng.integers(0, 256, 16384, dtype=np.uint8)
    rec[::2] = 0x41  # stride-2 structure
    lits = np.concatenate([text, rec])
    types = np.concatenate([np.zeros(len(text), np.int64),
                            np.ones(len(rec), np.int64)])
    best, costs = TA.stride_eval_per_block(lits, types, 2)
    assert costs.shape == (2, 8)
    assert best[1] in (2, 4, 6, 8)
    assert costs[0, best[0] - 1] == costs[0].min()
