"""The batch decoder's native header walk (csrc/lane_walk.cpp, through
native_bridge.lane_walk and batch_gpu._native_walk) against its Python
walk (batch_gpu._walk_from), the oracle, on the CPU.

Each case walks a stream from its start and from every resume point: the
bit after each compressed metablock, with the distance ring and output
length there, as the pure-Python host decoder reaches them (the device
reports the same end bit and ring).  Where the Python walk returns a
plan, the native walk returns the same one: every lane field, `pending`
and each segment's bytes.  Where the Python walk returns None or raises,
the native walk refuses.  The one stream the native walk refuses and
the Python walk plans is one with more uncompressed metablocks before a
compressed one than the native walk's segment buffer holds.

Streams: google's q1 and q3 (libbrotlienc), compress_fast streams cut
into 256- and 400-byte metablocks, streams spliced from those with
uncompressed and metadata metablocks before and between compressed
ones, walk-only streams, dirty padding, corrupt headers, multi-type and
multi-tree q11 streams, every byte cut of a small q1 stream.  Then whole batches through
decompress_batch_gpu on the CPU, against the JAX package's
decompress_batch_tpu and against the route with the native walk off.
"""

import numpy as np
import pytest

from brotli_tpu.decode.batch_tpu import decompress_batch_tpu
from brotli_tpu_torch import compress, decompress, decompress_batch_gpu
from brotli_tpu_torch import native_bridge as nb
from brotli_tpu_torch.core import constants as C
from brotli_tpu_torch.core.bitio import BitReader, BitWriter
from brotli_tpu_torch.core.prefix import write_prefix_code
from brotli_tpu_torch.decode import batch_gpu as B
from brotli_tpu_torch.decode.decoder import Decoder, _read_window_bits
from brotli_tpu_torch.encode import fast as TF
from . import oracle
from .test_torch_encoder import dictionary_slice, phrases
from .torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TEXT = phrases(70_000, seed=211) + dictionary_slice(60_000, 62_000)
CACHE0 = C.INITIAL_DISTANCE_CACHE


def _needs_oracle():
    if not oracle.available():
        pytest.skip("libbrotlienc is needed for google's streams")


def _fast_stream(data: bytes, shard: int) -> bytes:
    """compress_fast's stream of `data` in metablocks of `shard` bytes."""
    old = TF.SHARD
    TF.SHARD = shard
    try:
        return TF.compress_fast(data, lgwin=18, device="cpu")
    finally:
        TF.SHARD = old


def _resume_points(stream: bytes):
    """(bit_pos, cache, window, out_len) after each compressed metablock
    the pure-Python decoder reads, up to where it stops (the end, or an
    error after them)."""
    points = []
    dec = Decoder()
    run = dec._decode_compressed_metablock

    def record(reader, out, mlen, window_size, dist_cache, *rest):
        run(reader, out, mlen, window_size, dist_cache, *rest)
        points.append((reader.bit_pos, list(dist_cache), window_size,
                       len(out)))

    dec._decode_compressed_metablock = record
    try:
        dec.decompress(stream)
    except B._WALK_ERRORS:
        pass
    return points


def _python(data, bit_pos=-1, window=0, cache=CACHE0, out_len=0):
    """_walk_from's (segs, pending) from the stream header (bit_pos -1)
    or a resume point, or the error it raises."""
    reader = BitReader(data)
    try:
        if bit_pos < 0:
            window = (1 << _read_window_bits(reader)) - 16
        else:
            reader.bit_pos = bit_pos
        return B._walk_from(data, reader, window, list(cache), out_len)
    except B._WALK_ERRORS as e:
        return e


def _assert_same(got, want):
    (gsegs, gpend), (wsegs, wpend) = got, want
    assert gpend == wpend
    assert [k for k, _ in gsegs] == [k for k, _ in wsegs]
    for (kind, g), (_, w) in zip(gsegs, wsegs):
        if kind == "bytes":
            assert g == w
            continue
        for f in B._Lane.__slots__:
            a, b = getattr(g, f), getattr(w, f)
            if f.endswith("_len") and f != "out_prefix_len":
                assert len(a) == len(b), f
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                assert a == b, f


def _check(data, bit_pos=-1, window=0, cache=CACHE0, out_len=0,
           refuse_ok=False):
    """The native walk against the Python walk at one point.  Returns
    "plan", "refused" or "error" (the Python walk's answer)."""
    got = B._native_walk(data, bit_pos, window, cache, out_len)
    want = _python(data, bit_pos, window, cache, out_len)
    if isinstance(want, Exception) or want[0] is None:
        assert got is None, want
        return "error" if isinstance(want, Exception) else "refused"
    if got is None:
        assert refuse_ok, "the native walk refused a plan"
        return "plan"
    _assert_same(got, want)
    return "plan"


def _check_all(stream, refuse_ok=False):
    """From the start and from every resume point; the answers."""
    answers = [_check(stream, refuse_ok=refuse_ok)]
    for bit_pos, cache, window, out_len in _resume_points(stream):
        answers.append(_check(stream, bit_pos, window, cache, out_len,
                              refuse_ok))
    return answers


# -- streams spliced from compress_fast's metablocks -------------------


def _copy_bits(w: BitWriter, data: bytes, start: int, end: int):
    r = BitReader(data)
    r.bit_pos = start
    while r.bit_pos < end:
        n = min(32, end - r.bit_pos)
        w.write(r.read(n), n)


def _pad(w: BitWriter, dirty: bool):
    """To the byte boundary: zeros, or (dirty) ones, where there is a
    bit to set."""
    n = (8 - w.bitpos) & 7
    if dirty:
        assert n, "no padding bit to set here"
        w.write((1 << n) - 1, n)
    w.align_to_byte()


def _metadata(w: BitWriter, payload: bytes, last=False, dirty=False):
    w.write(int(last), 1)
    if last:
        w.write(0, 1)                      # ISLASTEMPTY
    w.write(3, 2)                          # MNIBBLES: metadata
    w.write(0, 1)                          # reserved
    if payload:
        nbytes = max(1, ((len(payload) - 1).bit_length() + 7) // 8)
        w.write(nbytes, 2)
        w.write(len(payload) - 1, 8 * nbytes)
    else:
        w.write(0, 2)
    _pad(w, dirty)
    w.write_bytes(payload)


def _uncompressed(w: BitWriter, payload: bytes, dirty=False):
    w.write(0, 1)                          # ISLAST
    w.write(0, 2)                          # MNIBBLES: 4
    w.write(len(payload) - 1, 16)
    w.write(1, 1)                          # ISUNCOMPRESSED
    _pad(w, dirty)
    w.write_bytes(payload)


def _last_empty(w: BitWriter, dirty=False):
    w.write(3, 2)                          # ISLAST, ISLASTEMPTY
    _pad(w, dirty)


@pytest.fixture(scope="module")
def parts():
    """A compress_fast stream of four 256-byte metablocks, cut into its
    stream header and its metablocks' bit ranges (three non-final, one
    final)."""
    s = _fast_stream(TEXT[5000:6024], 256)
    r = BitReader(s)
    _read_window_bits(r)
    ends = [p[0] for p in _resume_points(s)]
    assert len(ends) == 4
    starts = [r.bit_pos] + ends[:-1]
    return s, r.bit_pos, list(zip(starts, ends))


def _splice(parts, layout):
    """A stream of the source's header and the pieces of `layout`:
    "mbN" the source's metablock N (0-2 non-final, 3 final), "meta" a
    metadata block, "raw" an uncompressed one, "raw1" one of one byte,
    "empty" ISLASTEMPTY, "last_meta" a final metadata block, and
    "dirty_*" those with a padding bit set."""
    s, head, mbs = parts
    w = BitWriter()
    _copy_bits(w, s, 0, head)
    rng = np.random.default_rng(len(layout))
    for piece in layout:
        dirty = piece.startswith("dirty_")
        kind = piece.removeprefix("dirty_")
        if kind.startswith("mb"):
            _copy_bits(w, s, *mbs[int(kind[2:])])
        elif kind == "meta":
            _metadata(w, rng.integers(0, 256, 300, np.uint8).tobytes(),
                      dirty=dirty)
        elif kind == "last_meta":
            _metadata(w, b"end", last=True, dirty=dirty)
        elif kind == "raw":
            _uncompressed(w, TEXT[:int(rng.integers(1, 400))], dirty=dirty)
        elif kind == "raw1":
            _uncompressed(w, TEXT[:1])
        elif kind == "empty":
            _last_empty(w, dirty=dirty)
        elif kind in CORRUPT_PIECES:
            CORRUPT_PIECES[kind](w)
        else:
            raise ValueError(piece)
    return w.getvalue()


def _nonminimal_metadata(w: BitWriter):
    """MSKIPBYTES 2 for a length under 257."""
    w.write(0, 1)
    w.write(3, 2)
    w.write(0, 1)
    w.write(2, 2)
    w.write(4, 16)
    _pad(w, False)
    w.write_bytes(bytes(5))


def _reserved_metadata(w: BitWriter):
    w.write(0, 1)
    w.write(3, 2)
    w.write(1, 1)                          # the reserved bit
    w.write(0, 2)
    _pad(w, False)


def _nonminimal_uncompressed(w: BitWriter):
    """MNIBBLES 5 for a length under 65537."""
    w.write(0, 1)
    w.write(1, 2)
    w.write(9, 20)
    w.write(1, 1)
    _pad(w, False)
    w.write_bytes(TEXT[:10])


def _oversubscribed(w: BitWriter):
    """A final compressed metablock whose literal code's lengths (2, 1,
    1) oversubscribe it; its command and distance codes are sound."""
    w.write(1, 1)                          # ISLAST
    w.write(0, 1)                          # ISLASTEMPTY
    w.write(0, 2)                          # MNIBBLES: 4
    w.write(99, 16)                        # MLEN - 1
    w.write(0, 3)                          # NBLTYPESL, I, D: 1
    w.write(0, 6)                          # NPOSTFIX, NDIRECT
    w.write(0, 2)                          # the literal context mode
    w.write(0, 2)                          # NTREESL, NTREESD: 1
    w.write(0, 2)                          # HSKIP 0: a complex code
    w.write(0b0111, 4)                     # symbols 1 and 2 of the
    w.write(0b0111, 4)                     # code-length code: 1 bit
    w.write(1, 1)                          # length 2
    w.write(0, 1)                          # length 1
    w.write(0, 1)                          # length 1
    for n in (704, 64):
        lengths = np.zeros(n, np.int64)
        lengths[1] = 1
        write_prefix_code(w, lengths)
    _pad(w, False)
    w.write_bytes(bytes(16))


CORRUPT_PIECES = {"nonmin_meta": _nonminimal_metadata,
                  "reserved_meta": _reserved_metadata,
                  "nonmin_raw": _nonminimal_uncompressed,
                  "oversubscribed": _oversubscribed}


SPLICED = {
    "raw_meta_first": ["meta", "raw", "mb0", "mb1", "mb2", "mb3"],
    "between": ["mb0", "meta", "raw", "mb1", "raw", "raw", "mb2", "meta",
                "mb3"],
    "raw_then_empty": ["mb0", "mb1", "raw", "empty"],
    "last_metadata": ["raw", "mb0", "meta", "mb1", "last_meta"],
    "walk_only": ["raw", "meta", "raw", "empty"],
    "walk_only_metadata": ["meta", "raw", "last_meta"],
    "full_buffer": ["raw1"] * nb.LANE_WALK_MAX_PRE + ["mb3"],
}
DIRTY = {
    "dirty_empty_first": ["meta", "dirty_empty"],
    "dirty_raw_first": ["meta", "dirty_raw", "mb3"],
    "dirty_meta_first": ["meta", "dirty_meta", "mb3"],
    "dirty_empty_resumed": ["mb0", "meta", "dirty_empty"],
    "dirty_raw_resumed": ["mb0", "meta", "dirty_raw", "mb3"],
    "dirty_meta_resumed": ["mb0", "meta", "dirty_meta", "mb3"],
}
CORRUPT = {f"{k}_{where}": (["mb0"] if where == "resumed" else [])
           + ["meta", k] + (["mb3"] if k != "oversubscribed" else [])
           for k in CORRUPT_PIECES for where in ("first", "resumed")}


# -- the cases ----------------------------------------------------------


@pytest.mark.parametrize("quality,size,lgwin", [
    (1, 700, 22), (1, 5000, 16), (1, 65536, 22),
    (3, 700, 22), (3, 5000, 16), (3, 65536, 22)])
def test_google_streams(quality, size, lgwin):
    """google's q1 and q3 streams: every walk the native walk's, and a
    64 KiB q1 stream's is paused at its compressed metablock and
    resumed to its empty last one."""
    _needs_oracle()
    s = oracle.compress(TEXT[1000:1000 + size], quality=quality,
                        lgwin=lgwin)
    answers = _check_all(s)
    assert set(answers) <= {"plan", "error"} and answers[0] == "plan"
    if (quality, size) == (1, 65536):
        assert _python(s)[1] is True and len(answers) == 2
        assert answers[1] == "plan"


@pytest.mark.parametrize("shard", [256, 400])
@pytest.mark.parametrize("size", [300, 1200, 2100])
def test_fast_streams_every_resume_point(shard, size):
    s = _fast_stream(TEXT[9000:9000 + size], shard)
    answers = _check_all(s)
    n_meta = -(-size // shard)
    assert len(answers) == n_meta + 1
    # one plan a metablock; past the final one the walk reads padding
    assert answers[:n_meta] == ["plan"] * n_meta


@pytest.mark.parametrize("name", list(SPLICED))
def test_spliced_streams(parts, name):
    """Uncompressed and metadata metablocks before and between the
    compressed ones, streams that end in the walk, and exactly as many
    uncompressed metablocks as the native buffer holds."""
    layout = SPLICED[name]
    s = _splice(parts, layout)
    decompress(s)      # a sound stream: the host decoder takes it
    # a plan at the start and after each non-final compressed metablock
    walks = sum(p.startswith("mb") for p in layout) + (layout[-1] != "mb3")
    assert _check_all(s)[:walks] == ["plan"] * walks


@pytest.mark.parametrize("name", list(DIRTY))
def test_dirty_padding_refused(parts, name):
    """A padding bit set before an uncompressed or metadata block's
    bytes, or after ISLASTEMPTY: the Python walk raises where it meets
    it, and the native walk refuses there."""
    s = _splice(parts, DIRTY[name])
    answers = _check_all(s)
    assert answers[0 if name.endswith("_first") else 1] == "error"
    with pytest.raises(B.BrotliDecodeError):
        decompress(s)


@pytest.mark.parametrize("name", list(CORRUPT))
def test_corrupt_headers_refused(parts, name):
    """A non-minimal MSKIPBYTES or MNIBBLES, a reserved bit set, an
    oversubscribed prefix code: the Python walk raises where it meets
    it, and the native walk refuses there."""
    s = _splice(parts, CORRUPT[name])
    answers = _check_all(s)
    assert answers[0 if name.endswith("_first") else 1] == "error"


def test_walk_only_byte():
    """b"\\x3b": an empty stream (WBITS 22, ISLASTEMPTY); a padding bit
    set in it is refused."""
    assert _check(b"\x3b") == "plan"
    assert B._native_walk(b"\x3b", -1, 0, CACHE0, 0) == ([], False)
    assert _check(b"\xbb") == "error"


def test_more_segments_than_the_buffer_refused(parts):
    """One uncompressed metablock more than the native buffer holds: the
    native walk refuses, the Python walk plans, and _try_parse_stream
    returns the Python plan."""
    s = _splice(parts, ["raw1"] * (nb.LANE_WALK_MAX_PRE + 1) + ["mb3"])
    assert B._native_walk(s, -1, 0, CACHE0, 0) is None
    assert _check(s, refuse_ok=True) == "plan"
    _assert_same(B._try_parse_stream(s), _python(s))


@pytest.mark.parametrize("source,lo,hi", [
    ("compress", 20000, 30000), ("google", 20000, 30000),
    ("google", 0, 3000)])
def test_multi_type_q11_refused(source, lo, hi):
    """A q11 stream's metablock has more than one block type, or (google
    on the first 3,000 bytes) one block type and three literal trees:
    the Python walk returns None and the native walk refuses."""
    data = TEXT[lo:hi]
    if source == "google":
        _needs_oracle()
        s = oracle.compress(data, quality=11)
    else:
        s = compress(data, quality=11)
    assert _check(s) == "refused"


def test_every_byte_cut_of_a_q1_stream():
    """Every prefix of a small q1 stream, from its start and from its
    resume point: the native walk plans where the Python walk does (a
    cut past the headers) and refuses where it raises."""
    _needs_oracle()
    s = oracle.compress(TEXT[40000:40600], quality=1)
    ((bit_pos, cache, window, out_len),) = _resume_points(s)
    seen = set()
    for cut in range(len(s) + 1):
        seen.add(_check(s[:cut]))
        seen.add(_check(s[:cut], bit_pos, window, cache, out_len))
    assert seen == {"plan", "error"}


def test_resume_wrap_point_counts(parts):
    """_try_parse_stream and _resume_parse_stream take the native walk
    and count it; with the native walk refusing they return the Python
    walk's plan and count that."""
    s = _splice(parts, SPLICED["between"])
    (bit_pos, cache, window, out_len) = _resume_points(s)[0]
    stats = {}
    with B.trace.recording("probe", stats, B.DECODE_COUNTERS):
        first = B._try_parse_stream(s)
        resumed = B._resume_parse_stream(s, bit_pos, cache, window, out_len)
    assert (stats["walks_native"], stats["walks_python"],
            stats["walks_resumed"]) == (2, 0, 0)
    _assert_same(first, _python(s))
    _assert_same(resumed, _python(s, bit_pos, window, cache, out_len))


# -- whole batches -------------------------------------------------------


@pytest.fixture(scope="module")
def mixed_batch(parts):
    _needs_oracle()
    streams = [oracle.compress(TEXT[100:800], quality=1),
               oracle.compress(TEXT[900:2400], quality=3),
               oracle.compress(TEXT[3000:3300], quality=1, lgwin=16),
               _fast_stream(TEXT[12000:12900], 400),
               compress(TEXT[20000:30000], quality=11),
               b"\x3b"]
    streams += [_splice(parts, SPLICED[k])
                for k in ("raw_meta_first", "between", "last_metadata",
                          "walk_only")]
    return streams


def test_batch_matches_jax(mixed_batch):
    """Outputs and n_device equal the JAX package's batch decoder's, and
    the host decoder's outputs."""
    got = decompress_batch_gpu(mixed_batch, device="cpu")
    assert got == decompress_batch_tpu(mixed_batch)
    assert got[0] == [decompress(s) for s in mixed_batch]


def test_batch_matches_the_python_walk(monkeypatch, mixed_batch):
    """The same outputs and n_device with every walk in Python (the
    native walk refuses only the q11 stream)."""
    stats = {}
    got = decompress_batch_gpu(mixed_batch, device="cpu", stats=stats)
    assert stats["walks_python"] == 1 and stats["walks_resumed"] == 0
    monkeypatch.setattr(nb, "lane_walk", lambda *a: None)
    py_stats = {}
    assert decompress_batch_gpu(mixed_batch, device="cpu",
                                stats=py_stats) == got
    assert py_stats["walks_native"] == 0
    assert (py_stats["walks_python"] + py_stats["walks_resumed"]
            == stats["walks_native"] + stats["walks_python"])
