"""TPU probe #9's entry point in brotli_tpu_torch, and step_probe's plan.

brotli_tpu_torch/research/decode_step_kernel_probe.py against
research/decode_step_kernel_probe.py: its constants, its result keys on
the CPU, and its chain_time against the reference's own on one stub
clock.  ops/decode_gpu.step_probe_plan: every lane once, shared bytes
within a CTA's limit, a raise where a row cannot fit, and the constants
csrc/decode_step.cu was built with.  Tolerance: exact equality.
"""

import importlib.util
import os
import re
import types

import numpy as np
import pytest
import torch

from brotli_tpu_torch.ops import decode_gpu as D
from brotli_tpu_torch.research import decode_step_kernel_probe as P
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"P3_vector_only": {"us_per_step"},
        "P1_one_read": {"us_per_step", "est_MBps_128lanes"},
        "P2_two_reads": {"us_per_step", "est_MBps_128lanes"}}


def _reference():
    path = os.path.join(ROOT, "research", "decode_step_kernel_probe.py")
    spec = importlib.util.spec_from_file_location("decode_step_probe_ref",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_constants_are_the_references():
    ref = _reference()
    assert (P.LANES, P.STEPS) == (ref.LANES, ref.STEPS)
    src = open(os.path.join(ROOT, "research",
                            "decode_step_kernel_probe.py")).read()
    for name in KEYS:
        assert f'"{name}"' in src
    assert "128 * 1.8" in src and P.BYTES_PER_SYMBOL == 1.8
    assert f"({ref.LANES}, {P.WIDTH})" in src.replace("LANES", str(ref.LANES))
    tab, st = P.inputs(torch.device("cpu"))
    np.testing.assert_array_equal(
        tab.numpy(), np.arange(P.LANES * P.WIDTH, dtype=np.int32)
        .reshape(P.LANES, P.WIDTH) % 997)
    assert st.shape == (1, P.LANES) and st.dtype == torch.int32


def test_run_on_cpu_returns_the_references_keys():
    before = dict(D.LAUNCHES)
    res = P.run(device="cpu", reps=2, steps=8)
    assert D.LAUNCHES == before
    assert {k: set(v) for k, v in res.items()} == KEYS
    for v in res.values():
        assert all(isinstance(x, float) and np.isfinite(x)
                   for x in v.values())
    with pytest.raises(ValueError):
        P.run(device="cpu", reps=1, steps=8)


@pytest.mark.parametrize("reps", [2, 5])
def test_chain_time_is_the_references_formula(reps):
    """A stub clock: each step call costs 1.5 s, each clock read 0.25 s.
    Both chain_times must give (chain of reps - one call) / (reps - 1)
    = 1.5 s exactly, over the same calls."""
    clock = [0.0]

    def read():
        clock[0] += 0.25
        return clock[0]

    calls = []

    def step(x):
        calls.append(1)
        clock[0] += 1.5
        return x + 1

    x0 = np.zeros((1, 8), np.int32)
    ours = P.chain_time(step, x0, reps, clock=read)
    n_ours = len(calls)
    ref = _reference()
    ref.time = types.SimpleNamespace(perf_counter=read)
    calls.clear()
    theirs = ref.chain_time(step, x0, reps)
    assert ours == theirs == 1.5
    assert n_ours == len(calls) == 1 + 2 * (1 + reps)


ALIGN = D.PROBE_ROW_ALIGN
# the widest row that fits: whole aligned rows after the first's slack
WIDEST = (D.SMEM_MAX - ALIGN) // ALIGN * ALIGN // 4


@pytest.mark.parametrize("width", [1024, 1026, 1056, 4096, WIDEST])
def test_step_probe_plan_covers_every_lane(width):
    stride = -(-4 * width // ALIGN) * ALIGN
    for sms in (132, 1):
        for lanes in range(1, 1001):
            p = D.step_probe_plan(lanes, width, sms)
            per = p["lanes_per_cta"]
            assert 1 <= per <= D.PROBE_MAX_LANES
            assert p["ctas"] * per >= lanes > (p["ctas"] - 1) * per
            assert p["threads"] == 32 * per
            # each row on an aligned boundary, with slack for the first
            assert p["smem_bytes"] == ALIGN + per * stride <= D.SMEM_MAX
            assert stride >= 4 * width
            if lanes >= sms:
                assert per == min(D.PROBE_MAX_LANES, lanes // sms,
                                  (D.SMEM_MAX - ALIGN) // stride)
    assert D.step_probe_plan(128, width, 132)["ctas"] == 128


@pytest.mark.parametrize("width", [WIDEST + 1, D.SMEM_MAX // 4, 1 << 20])
def test_step_probe_plan_raises_where_a_row_cannot_fit(width):
    with pytest.raises(ValueError):
        D.step_probe_plan(1, width, 132)


def test_step_probe_rejects_read_counts_the_probe_has_not():
    tab, st = P.inputs(torch.device("cpu"))
    for reads in (-1, 3):
        with pytest.raises(ValueError):
            D.step_probe(tab, st, 4, reads)
    assert D.PROBE_READS == (0, 1, 2)


def test_kernel_constants_are_the_wrappers():
    src = open(os.path.join(ROOT, "brotli_tpu_torch", "csrc",
                            "decode_step.cu")).read()
    assert int(re.search(r"PROBE_MAX_LANES = (\d+);", src).group(1)) \
        == D.PROBE_MAX_LANES
    assert int(re.search(r"MAX_SMEM = (\d+);", src).group(1)) == D.SMEM_MAX
    assert int(re.search(r"PROBE_ROW_ALIGN = (\d+);", src).group(1)) \
        == D.PROBE_ROW_ALIGN
    assert int(re.search(r"LAT_UNROLL = (\d+),", src).group(1)) \
        == D._LAT_UNROLL
    from brotli_tpu_torch.ops import match_rounds_cuda as MR
    mr = open(os.path.join(ROOT, "brotli_tpu_torch", "csrc",
                           "match_rounds.cu")).read()
    assert int(re.search(r"THREADS = (\d+);", mr).group(1)) == MR.THREADS
    assert int(re.search(r"MAX_K = (\d+);", mr).group(1)) == MR.MAX_K


def test_step_latency_cycles_is_the_critical_path():
    lat = {"IMAD": 4.0, "LOP3": 2.5, "IADD3": 2.0, "LDS": 30.0}
    assert D.step_latency_cycles(0, lat) == 1.0
    assert D.step_latency_cycles(1, lat) == 4.0 + 2.5 + 30.0 + 4.0
    assert D.step_latency_cycles(2, lat) == 4.0 + 2.5 + 30.0 + 2.0 + 4.0
