"""The fold kernel's early exits are exact, and its launch plan.

csrc/fold.cu stops a row's scan at exits taken from the sort order:
the first neighbour of another v0 (every configuration), and with one
key the first forward neighbour past the window, past min_pos, or past
the score bound.  They rest on the wrappers' sorts keeping v0 runs
contiguous and, with one key, pos ascending within a run; these tests
check that on seeded data with top-bit keys, and that fold_sorted_exits
(the same scan in torch, the rule chip_smoke.py's bound counts) gives
fold_sorted_ref's outputs bit for bit in every configuration on the
inputs of tests/fold_edges.py.  Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from brotli_tpu_torch.ops import fold_cuda as F

from .fold_edges import CASES, CONFIGS, edge_case, phrases
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _sorted(data: np.ndarray, n_keys: int, n_pay: int):
    row = torch.from_numpy(data)
    if n_keys == 1:
        return F._sort_v0(row, [F.u32_values_at(row, 4 * r)
                                for r in range(1, n_pay + 1)])
    return F._sort_v0v1(row, n_pay + 2)


@pytest.mark.parametrize("n_keys", [1, 2])
def test_sorts_keep_v0_runs_contiguous(n_keys):
    d = phrases(20000, seed=3)
    ops = _sorted(d, n_keys, 1)
    v0 = ops[0].numpy()
    assert (v0.view(np.uint32) >= 1 << 31).any()
    starts = np.flatnonzero(np.diff(v0) != 0)
    assert len(starts) + 1 == len(np.unique(v0))   # one block per v0
    if n_keys == 1:
        pos = ops[1].numpy()
        same = v0[1:] == v0[:-1]
        assert (pos[1:][same] > pos[:-1][same]).all()
        assert (np.diff(v0) >= 0).all()            # signed order
    else:
        assert (np.diff(v0.view(np.uint32).astype(np.int64)) >= 0).all()


@pytest.mark.parametrize("mid", [False, True])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("config", CONFIGS)
def test_exit_scan_matches_ref(config, case, mid):
    n_keys, n_pay, k_fwd, k_back, fuse = config
    data, window, n_real = edge_case(case)
    ops = _sorted(data, n_keys, n_pay)
    min_pos = len(data) // 2 if mid else 0
    kw = dict(n_keys=n_keys, k_fwd=k_fwd, k_back=k_back, window=window,
              lbs=135, len_shift=26, n_real=n_real, fuse_short=fuse)
    rp, rs = F.fold_sorted_ref(ops, min_pos, **kw)
    ep, es, pairs = F.fold_sorted_exits(ops, min_pos, **kw)
    assert torch.equal(ep, rp) and torch.equal(es, rs)
    assert int((rp != 0).sum()) > 0
    n = len(data)
    assert 0 <= int(pairs.min()) and int(pairs.max()) <= k_fwd + k_back
    if n_keys == 1:   # the distance and score exits cut pairs
        assert int(pairs.sum()) < n * k_fwd // 2


@pytest.mark.parametrize("config", CONFIGS)
def test_fold_plan(config):
    n_keys, n_pay, k_fwd, k_back, fuse = config
    n = 4_718_592
    plan = F.fold_plan(n, n_keys, n_pay, k_fwd, k_back, fuse)
    compact = n_keys == 1 and n_pay <= 1
    n_rec = F.TILE_ROWS + k_fwd + k_back   # records; a second plane
    planes = n_rec if n_keys + 1 + n_pay <= 4 else 576 + n_rec
    assert plan == dict(
        route="compact" if compact else "rows", tile_rows=F.TILE_ROWS,
        threads=256, ctas=n // F.TILE_ROWS,
        smem_bytes=16 * planes + (12 * F.TILE_ROWS if compact else 0))
    assert F.fold_plan(F.TILE_ROWS + 1, n_keys, n_pay, k_fwd, k_back,
                       fuse)["ctas"] == 2


@pytest.mark.parametrize("args", [(1, 1, 16, 0, True), (2, 0, 40, 30, False),
                                  (3, 0, 16, 0, False), (1, 6, 16, 0, False)])
def test_fold_plan_raises_where_no_kernel(args):
    with pytest.raises(ValueError):
        F.fold_plan(1000, *args)
