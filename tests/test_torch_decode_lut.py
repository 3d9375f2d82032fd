"""The decode kernel's root tables and plan, on the CPU.

brotli_tpu_torch.ops.decode_gpu.build_tree_lut and its plain table
decode `lut_tree_decode_ref` (the root entry, then the compare rule from
length bits + 1) against the compare-rule decoders, the port's
`_tree_decode` and brotli_tpu.ops.decode_tpu._tree_decode, on all
32,768 15-bit windows, for literal, command and distance trees: seeded
random complete codes, codes no longer than the table's bits, codes of
every length past them, a one-symbol tree and an incomplete one.  The
command table's codes are held against the constant tables.  Then the
layout that csrc/decode_step.cu reads (its constants, the lane table,
the padded rows), decode_step_plan, and research/root_bits.py's share
of codes past a table.  Every comparison is exact.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brotli_tpu.ops import decode_tpu as JD
from brotli_tpu_torch.core import constants as C
from brotli_tpu_torch.ops import decode_gpu as D
from brotli_tpu_torch.research.root_bits import long_share
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOWS = 1 << 15
TREES = {"literal": (256, D.LUT_BITS[0]), "command": (704, D.LUT_BITS[1]),
         "distance 64": (64, D.LUT_BITS[2]),
         "distance 520": (520, D.LUT_BITS[2])}


def _complete(rng, nsym: int, max_depth: int) -> list:
    """Depths of a complete code of nsym leaves, none deeper than
    max_depth (split a random leaf until there are nsym)."""
    leaves = [0]
    while len(leaves) < nsym:
        cand = [k for k, d in enumerate(leaves) if d < max_depth]
        leaves += [leaves.pop(cand[int(rng.integers(0, len(cand)))]) + 1] * 2
    return leaves


def _lengths(shape: str, a: int, bits: int, seed: int) -> np.ndarray:
    """One tree's code lengths [a] of the given shape."""
    rng = np.random.default_rng(seed)
    out = np.zeros(a, np.int32)
    if shape == "one symbol":
        out[a // 3] = 1
        return out
    if shape == "incomplete":            # codes 0 and 10 only
        out[[5, a - 1]] = [1, 2]
        return out
    nsym = int(rng.integers(24, min(a - 16, 300) + 1))
    if shape == "random":
        leaves = _complete(rng, nsym, 15)
    elif shape == "at most bits":        # and at least one code of bits
        leaves = _complete(rng, nsym, bits)
        while max(leaves) < bits:        # split the deepest leaf
            leaves += [leaves.pop(leaves.index(max(leaves))) + 1] * 2
    else:                                # every length past bits
        leaves = _complete(rng, nsym, bits)
        d = leaves.pop(leaves.index(max(leaves)))
        while d < 15:                    # a chain down to depth 15
            leaves.append(d + 1)
            d += 1
        leaves.append(15)
    out[rng.choice(a, size=len(leaves), replace=False)] = leaves
    return out


SHAPES = ("random", "at most bits", "past bits", "one symbol", "incomplete")


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("shape", SHAPES)
def test_root_table_decode_matches_compare_rule(tree, shape):
    a, bits = TREES[tree]
    lengths = _lengths(shape, a, bits, seed=len(tree) * 31 + len(shape))
    present = lengths[lengths > 0]
    if shape == "at most bits":
        assert present.max() == bits
    if shape == "past bits":
        assert set(range(bits + 1, 16)) <= set(present.tolist())
    cmd = tree == "command"
    one = D.build_tree_device(torch.from_numpy(lengths[None, :]))
    lut = D.build_tree_lut(one, bits, cmd=cmd)
    assert lut.shape == (1, 1 << bits) and lut.dtype == torch.int32
    # every window, one lane each: the tree's rows broadcast to them
    wide = {k: v.expand(WINDOWS, *v.shape[1:]) for k, v in one.items()}
    w = torch.arange(WINDOWS, dtype=torch.int64)
    got = D.lut_tree_decode_ref(lut.expand(WINDOWS, -1), wide, bits, w,
                                cmd=cmd)
    want = D._tree_decode(wide, w)
    jt = {k: jnp.broadcast_to(jnp.asarray(v.numpy()), (WINDOWS,) + v.shape[1:])
          for k, v in one.items()}
    jwant = JD._tree_decode(jt, jnp.asarray(w.numpy().astype(np.uint32)))
    for name, g, t, j in zip(("symbol", "bits", "bad"), got, want, jwant):
        np.testing.assert_array_equal(g.numpy(), t.numpy(), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j),
                                      err_msg=name)
    if shape == "incomplete":
        assert bool(got[2].any())
    if shape in ("past bits", "random"):
        long = (lut[0].long() & D.LUT_LONG) != 0
        assert bool(long.any()) == (present.max() > bits)
    if cmd:
        s = got[0].clamp(0, 703).numpy()
        for k, table in zip(got[3:], (C.CMD_TO_INSERT_CODE,
                                      C.CMD_TO_COPY_CODE,
                                      C.CMD_IMPLICIT_DIST0)):
            np.testing.assert_array_equal(k.numpy(),
                                          np.asarray(table, np.int64)[s])


def test_kernel_layout_matches_source():
    """The constants csrc/decode_step.cu reads agree with the tables and
    the lane layout the wrapper builds."""
    with open(os.path.join(ROOT, "brotli_tpu_torch", "csrc",
                           "decode_step.cu")) as f:
        src = f.read()
    consts = {k: int(v) for k, v in re.findall(r"\b([A-Z_0-9]+) = (\d+)",
                                               src)}
    assert (consts["LIT_BITS"], consts["CMD_BITS"],
            consts["DIST_BITS"]) == D.LUT_BITS
    assert consts["HOT_INTS"] == D.HOT_INTS
    assert consts["ROW_INTS"] == D.ROW_INTS
    offsets, at = {}, 0
    for name, n in D._TABLE_LAYOUT:
        offsets[name] = at
        at += n
    assert offsets["ins_pack"] == consts["H_INS"]
    assert offsets["cpy_pack"] == consts["H_CPY"]
    assert offsets["sc_idx"] == consts["H_SC_IDX"]
    assert offsets["sc_delta"] == consts["H_SC_DELTA"]
    assert offsets["dict_sbits"] == consts["H_DICT_SBITS"]
    assert offsets["cmd2ins"] == consts["T_CMD2INS"]
    assert offsets["cmd2cpy"] == consts["T_CMD2CPY"]
    assert offsets["implicit0"] == consts["T_IMPL0"]
    assert offsets["dict_outlen"] == consts["T_DICT_OUTLEN"]
    assert "LUT_LONG = 1 << 4" in src and D.LUT_LONG == 1 << 4
    table = D._kernel_table(torch.device("cpu")).numpy()
    ins = table[:24]
    np.testing.assert_array_equal(ins >> 5, C.INSERT_BASE)
    np.testing.assert_array_equal(ins & 31, C.INSERT_EXTRA)
    np.testing.assert_array_equal(table[24:48] >> 5, C.COPY_BASE)
    np.testing.assert_array_equal(table[24:48] & 31, C.COPY_EXTRA)

    rng = np.random.default_rng(5)
    lens = [np.stack([_lengths("random", a, 15, seed=s) for s in range(3)])
            for a in (256, 704, 70)]
    trees = [D.build_tree_device(torch.from_numpy(x)) for x in lens]
    lt = D.lane_tables(trees)
    assert lt.shape == (3, D.LANE_INTS) and lt.dtype == torch.int32
    at = 0
    for k, (t, b) in enumerate(zip(trees, D.LUT_BITS)):
        assert torch.equal(lt[:, at:at + (1 << b)],
                           D.build_tree_lut(t, b, cmd=k == 1))
        at += 1 << b
    for t in trees:
        for key in ("first", "limit", "offset"):
            assert torch.equal(lt[:, at:at + 15], t[key])
            at += 16
    assert at == D.LANE_INTS

    data = torch.from_numpy(rng.integers(0, 256, (3, 37), dtype=np.uint8))
    rows = D._padded_rows(data)
    assert rows.shape[1] % 16 == 0 and rows.shape[1] >= 37 + 7
    assert torch.equal(rows[:, :37], data)
    assert bool((rows[:, 36:] == data[:, 36:37]).all())


@pytest.mark.parametrize("n", [1, 8, 13, 64, 131, 132, 1024, 1056, 5000])
def test_decode_step_plan(n):
    """Every lane has a slot, no CTA is empty, each CTA fits the card,
    and from 132 lanes on every one of 132 SMs gets a CTA."""
    p = D.decode_step_plan(n, 132)
    per = p["lanes_per_cta"]
    assert 1 <= per <= D.PLAN_MAX_WARPS and p["threads"] == 32 * per
    assert p["ctas"] * per >= n > (p["ctas"] - 1) * per
    assert p["smem_bytes"] == 4 * (D.HOT_INTS + per * D.LANE_INTS)
    assert p["smem_bytes"] <= D.SMEM_MAX == 232448
    assert p["ctas"] >= min(n, 132)
    with pytest.raises(ValueError):
        D.decode_step_plan(n, 0)


def test_long_share_counts_codes_past_the_table():
    """research/root_bits.py's share: 2**-length over the codes longer
    than the table, 0 for a one-symbol tree."""
    lengths = np.zeros(40, np.int32)
    lengths[:5] = [1, 2, 3, 4, 4]
    assert long_share(lengths, 4) == 0.0
    assert long_share(lengths, 3) == 2 * 2.0 ** -4
    assert long_share(lengths, 1) == 0.5
    one = np.zeros(40, np.int32)
    one[7] = 1
    assert long_share(one, 0) == 0.0
