"""compress_gpu's q9 matcher (the exact9 tier: the exact8 fold and the
short fold, merged on the host, capped lengths extended) against the
benchmark's plain reference, perfbench/plain_match9.py (numpy alone; it
imports nothing of either package).

Each case compresses seeded bytes with compress_gpu(quality=9,
device="cpu") through perfbench/card_match9.py, the check the card
runs: at every real position of every span the (len, dist) the host
leg makes after the merge and the extension equal the reference's, and
the program's count of the short fold's wins (match.short_won) equals
the reference's.  The cases cover a short last span (with lengths that
run into its zero fill), long runs of equal keys, matches at the
window's edge and at the row's first byte of data, ties between the
two folds' scores, and the inversion on the device.  The traced stream
equals the untraced one and libbrotlidec decodes it.  Tolerance: exact
equality.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from . import oracle
from brotli_tpu_torch import compress_gpu
from .test_torch_encoder import dictionary_slice, phrases
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PERFBENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "perfbench")


def _load(name):
    """perfbench/<name>.py by path, under its own name (card_match9
    imports plain_match9 by name, as the harness's modules import each
    other)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(PERFBENCH, name + ".py"))
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


P = _load("plain_match9")
card_match9 = _load("card_match9")


def _random(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                np.uint8).tobytes()


def _text():
    return phrases(30_000, seed=241) + dictionary_slice(52_000, 58_000)


def _runs():
    """Zeros from the first byte (the zero fill below min_pos has the
    same key), then long runs of one key: one byte, two, three."""
    return (bytes(3000) + b"ab" * 1500 + b"a" * 2500 + phrases(4000, 242)
            + b"abcabcab" * 400 + bytes(range(256)) * 8 + bytes(700))


def _window():
    """Repeats at distances 1000, 1008 (the window of lgwin 10) and 1009
    (one past it), then text."""
    a, b, c = _random(1000, 243), _random(1008, 244), _random(1009, 245)
    return a + a + b + b + c + c + phrases(2000, 246)


def _tail():
    """A short last span that ends in the last 20 bytes of a run that
    was followed by zeros: the fold reads the zero fill past the input
    as bytes, so lengths there run past the span's end."""
    x = _random(64, 247)
    return (phrases(6000, 248) + x + bytes(48) + phrases(3000, 249)
            + x[-20:])


CASES = {
    # name: (data, compress_gpu keywords, device inversion, figures > 0)
    "text": (_text, dict(lgwin=16, span=1 << 13), "0",
             ("short", "ties", "extended")),
    "text_device_invert": (_text, dict(lgwin=16, span=1 << 13), "1",
                           ("short", "ties", "extended")),
    "runs": (_runs, dict(lgwin=12, span=1 << 12), "0",
             ("extended", "at_min_pos")),
    "window": (_window, dict(lgwin=10, span=1 << 11), "0", ("short",)),
    "tail": (_tail, dict(lgwin=16, span=1 << 12), "0",
             ("past_end", "extended")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_q9_matcher_equals_the_plain_reference(case, monkeypatch):
    make, kw, invert, nonzero = CASES[case]
    monkeypatch.setenv("BROTLI_TPU_TORCH_DEVICE_INVERT", invert)
    data = make()
    stream, fig = card_match9.checked_compress(data, device="cpu", **kw)
    assert fig["spans"] == -(-len(data) // kw["span"])
    assert len(data) % kw["span"]              # a short last span
    assert fig["positions"] == len(data)
    assert fig["short_won"] == fig["short"]
    for k in nonzero:
        assert fig[k] > 0, (k, fig)
    if case == "window":
        assert fig["max_dist"] == (1 << 10) - 16
    assert stream == compress_gpu(data, quality=9, device="cpu", **kw)
    if oracle.available():
        assert oracle.decompress(stream) == data
