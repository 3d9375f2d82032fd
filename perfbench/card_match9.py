"""compress_gpu at quality 9 with its matcher held, span by span, to the
plain reference of plain_match9.py: each span's row and the (len, dist)
the host leg makes of the device's two folds (after the merge and the
extension of capped lengths) are taken as they pass, and must equal the
reference's at every real position; the program's count of the short
fold's wins (match.short_won) must equal the reference's.  For the
check of the card's matcher (perfbench/tests/test_q9.py) and of the
CPU's (tests/test_torch_plain_match9.py); the timed cell runs the
program unpatched.
"""

from __future__ import annotations

import inspect

import numpy as np

import plain_match9
from brotli_tpu_torch import compress_gpu
from brotli_tpu_torch.encode import gpu_path


def checked_compress(data: bytes, **kw):
    """compress_gpu(data, quality=9, **kw), traced, with every span's
    matches held to the plain reference; raises AssertionError at the
    first span that differs.  Returns (stream, figures): spans,
    positions, short (the reference's short-fold wins), short_won (the
    program's counter), ties (positions where the two folds' scores
    were equal), extended (positions whose length the extension
    changed), past_end (positions whose length runs past the span's
    real bytes, into a short last span's zero fill) and at_min_pos
    (positions whose match starts at the row's first byte of data),
    summed over the spans, and max_dist, the longest distance."""
    host_parse, score = gpu_path._host_parse, gpu_path.score_matches
    fig = dict(spans=0, positions=0, short=0, short_won=0, ties=0,
               extended=0, past_end=0, max_dist=0, at_min_pos=0)
    span, params = {}, inspect.signature(host_parse)

    def spy_host_parse(*a, **k):
        s = params.bind(*a, **k).arguments
        span.update(row=np.array(s["row"]), halo=s["halo"], real=s["real"],
                    min_pos=s["halo"] - s["dlen"],
                    window_size=s["window_size"])
        return host_parse(*a, **k)

    def spy_score(bl, bd, *a, **k):
        before = bl.copy()
        out = score(bl, bd, *a, **k)
        s = span
        want_l, want_d, short, tie = plain_match9.span_matches(
            s["row"], s["min_pos"], s["halo"], s["window_size"], s["real"])
        bad = np.nonzero((bl != want_l) | (bd != want_d))[0]
        if len(bad):
            i = int(bad[0])
            raise AssertionError(
                f"span {fig['spans']}: position {i} of {s['real']} is "
                f"(len, dist) ({bl[i]}, {bd[i]}), the plain reference's "
                f"({want_l[i]}, {want_d[i]}); {len(bad)} positions differ")
        fig["spans"] += 1
        fig["positions"] += s["real"]
        fig["short"] += int(short.sum())
        fig["ties"] += int(tie.sum())
        at = np.arange(s["real"])
        fig["past_end"] += int((want_l > s["real"] - at).sum())
        fig["max_dist"] = max(fig["max_dist"], int(want_d.max()))
        fig["at_min_pos"] += int(((want_d > 0) & (
            want_d == s["halo"] + at - s["min_pos"])).sum())
        fig["extended"] += int((bl != before).sum())
        return out

    gpu_path._host_parse, gpu_path.score_matches = spy_host_parse, spy_score
    stats = {}
    try:
        stream = compress_gpu(data, quality=9, stats=stats, **kw)
    finally:
        gpu_path._host_parse, gpu_path.score_matches = host_parse, score
    fig["short_won"] = stats["match.short_won"]
    if fig["short_won"] != fig["short"] or \
            stats["match.positions"] != fig["positions"]:
        raise AssertionError(
            f"match.short_won {stats['match.short_won']} of "
            f"{stats['match.positions']} positions, the plain reference's "
            f"{fig['short']} of {fig['positions']}")
    return stream, fig
