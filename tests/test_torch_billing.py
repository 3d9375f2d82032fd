"""The port's stream bit accounting (utils/billing.py) against
brotli_tpu.utils.billing, on the CPU.

account() decodes a stream through each package's pure-Python decoder
with a billing BitReader; every field it returns (bits by section,
stats, output_len, dist_trace, commands) must be equal (tolerance:
none), and the billed bits must cover the stream: at most 8 x its
length and at most 7 bits less (the final byte's padding is read by
align_to_byte, so it is billed too).  Streams come from the port's
compress at q0, q1, q5, q9 and q11, from libbrotlienc at q5 and lgwin
18, with a custom dictionary and with a large window; compare() must
print the same table.
"""

import io
from contextlib import redirect_stdout

import pytest

from brotli_tpu.utils import billing as JB
from brotli_tpu_torch import compress
from brotli_tpu_torch.core.bitio import BitReader
from brotli_tpu_torch.utils import billing as TB
from . import oracle
from .test_torch_encoder import dictionary_slice, phrases
from .test_torch_utils import records, repo_text
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DATA = phrases(24_000, seed=31) + repo_text(12_000) + records(4_000) \
    + dictionary_slice(70_000, 74_000)
DICTIONARY = repo_text(40_000)[20_000:]


def streams() -> dict:
    """name -> (stream, account() keyword arguments, plain bytes)."""
    out = {f"port_q{q}": (compress(DATA, quality=q, lgwin=18), {}, DATA)
           for q in (0, 1, 5, 9, 11)}
    out["libbrotlienc_q5_lgwin18"] = (oracle.compress(DATA, 5, 18), {},
                                      DATA)
    out["custom_dictionary"] = (
        compress(DATA, quality=9, custom_dictionary=DICTIONARY),
        dict(custom_dictionary=DICTIONARY), DATA)
    out["large_window"] = (
        compress(DATA, quality=9, lgwin=26, large_window=True),
        dict(large_window=True), DATA)
    out["empty"] = (compress(b"", quality=5), {}, b"")
    return out


STREAMS = streams()


def _check(name):
    stream, kw, plain = STREAMS[name]
    want = JB.account(stream, **kw)
    got = TB.account(stream, **kw)
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
    assert got["output_len"] == len(plain)
    total = sum(got["bits"].values())
    assert 8 * len(stream) - 7 <= total <= 8 * len(stream)
    return got


@pytest.mark.parametrize("name", STREAMS)
def test_account_matches_jax(name):
    got = _check(name)
    if name != "empty":
        assert got["stats"]["metablocks"] >= 1
        assert got["bits"]["lit_syms"] > 0
        assert got["commands"]


def test_account_bills_context_maps_and_block_switches():
    """q11's streams carry context maps and block switches: both are
    billed to their sections, equal in the two packages."""
    got = _check("port_q11")
    assert got["bits"]["context"] > 0
    assert got["stats"]["ntrees_l"] > got["stats"]["metablocks"]


def test_billing_reader_bills_what_it_reads():
    """read, skip and read_bytes each add their bits once, in the
    current section; peek adds none."""
    data = bytes(range(64))
    a, b = JB.BillingReader(data), TB.BillingReader(data)
    assert isinstance(b, BitReader)
    for r in (a, b):
        r.read(5)
        r.section = "x"
        r.peek(12)
        r.skip(3)
        r.read_bytes(4)
        r.read(13)
    assert b.bill == a.bill == {"header": 5, "x": 48}
    assert b.bit_pos == a.bit_pos == 53


@pytest.mark.parametrize("pair", [("port_q5", "libbrotlienc_q5_lgwin18"),
                                  ("port_q9", "port_q1")])
def test_compare_prints_the_same_table(pair):
    a, b = STREAMS[pair[0]][0], STREAMS[pair[1]][0]
    outs = []
    for mod in (JB, TB):
        buf = io.StringIO()
        with redirect_stdout(buf):
            ra, rb = mod.compare(a, b, label_a=pair[0], label_b=pair[1])
        outs.append((buf.getvalue(), ra["bits"], rb["bits"]))
    assert outs[1] == outs[0]
    assert outs[1][0].splitlines()[0].split() == [
        "section", pair[0], pair[1], "delta"]
