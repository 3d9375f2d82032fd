"""compress_gpu(max_device=True) with its device parse held, span by
span, to the plain walk of plain_parse.py: each span's fold outputs
(the program's own, from the card or the CPU) are taken as they pass,
and the commands the program assembles from its device parse must equal
the plain walk's over the same outputs.  For the checks of the card's
parse (perfbench/tests/test_maxdev.py, chip_smoke.py's path phase); the
timed cell runs the program unpatched.
"""

from __future__ import annotations

import plain_parse
from brotli_tpu_torch import compress_gpu
from brotli_tpu_torch.encode import gpu_path


def checked_compress(data: bytes, **kw):
    """compress_gpu(data, max_device=True, **kw) with every span's
    commands held to the plain walk; raises AssertionError at the first
    span that differs.  Returns (stream, figures): spans, commands,
    positions and the bytes the copies cover, summed over the spans."""
    fold, assemble = gpu_path.best_matches_exact_p, \
        gpu_path._commands_from_parse
    folds = []      # the fold outputs of the spans dispatched, in order
    fig = dict(spans=0, commands=0, positions=0, copied=0)

    def spy_fold(*a, **k):
        out = fold(*a, **k)
        folds.append(out.cpu())
        return out

    def spy_assemble(visited, take, dist, real):
        out = assemble(visited, take, dist, real)
        got = list(zip(*(x.tolist() for x in out[:3])))
        packed = folds.pop(0)[-len(visited):]
        want = plain_parse.span_commands(packed.tolist(), real)
        if got != want:
            k = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), min(len(got), len(want)))
            raise AssertionError(
                f"span {fig['spans']}: command {k} of {len(got)} is "
                f"{got[k:k + 1]}, the plain walk's of {len(want)} "
                f"{want[k:k + 1]}")
        fig["spans"] += 1
        fig["commands"] += len(got)
        fig["positions"] += real
        fig["copied"] += sum(c[1] for c in got)
        return out

    gpu_path.best_matches_exact_p = spy_fold
    gpu_path._commands_from_parse = spy_assemble
    try:
        stream = compress_gpu(data, max_device=True, **kw)
    finally:
        gpu_path.best_matches_exact_p = fold
        gpu_path._commands_from_parse = assemble
    return stream, fig
