"""Encoder parameters.

The port's copy of brotli_tpu/encode/params.py: every field of the
reference's EncoderParams (the Dropbox stream flags, the tuning knobs
and the IR fields), SanitizeParams' dependency rules, ComputeLgBlock,
the distance alphabet and the worst-case output bound.  from_reference
converts the JAX package's parameters for the device compress path,
which takes only the settings it supports.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

MIN_QUALITY = 0
MAX_QUALITY = 12
MIN_WINDOW_BITS = 10
MAX_WINDOW_BITS = 24
LARGE_MAX_WINDOW_BITS = 30
MIN_INPUT_BLOCK_BITS = 16
MAX_INPUT_BLOCK_BITS = 24

MODE_GENERIC = 0
MODE_TEXT = 1
MODE_FONT = 2


@dataclass
class DistanceParams:
    """Distance prefix parameters (NPOSTFIX/NDIRECT, RFC 7932 section 4)."""
    npostfix: int = 0
    ndirect: int = 0
    large_window: bool = False

    @property
    def alphabet_size(self) -> int:
        max_distbits = 62 if self.large_window else 24
        return 16 + self.ndirect + (max_distbits << (self.npostfix + 1))


@dataclass
class EncoderParams:
    quality: int = 11
    q9_5: bool = False            # the "9.5" pseudo-quality family
    q10_deep: bool = False        # q10 with the full 2-iteration refinement
    lgwin: int = 22
    lgblock: int = 0              # 0 = auto (ComputeLgBlock)
    mode: int = MODE_GENERIC
    size_hint: int = 0
    large_window: bool = False

    # stream-shaping flags
    catable: bool = False         # stream can be concatenated after another
    appendable: bool = False      # another stream may be appended
    bare: bool = False            # omit window header / final marker
    byte_align: bool = False      # pad final output to a byte boundary
    magic_number: bool = False    # magic-number metadata header

    # tuning
    literal_byte_score: int = 540
    avoid_distance_prefix_search: bool = False
    favor_cpu_efficiency: bool = False
    num_threads: int = 1
    # literals use one tree per block type (no context map)
    disable_literal_context_modeling: bool = False
    # the output sits at this byte offset of a larger stream: shifts
    # position-based distance legality
    stream_offset: int = 0

    # IR side channel
    log_meta_block: bool = False
    stride_detection_quality: int = 0
    prior_bitmask_detection: int = 0
    literal_adaptation: tuple = ()
    use_utf8_context_mode: bool | None = None  # None = auto-detect

    dist: DistanceParams = field(default_factory=DistanceParams)

    def sanitize(self, input_size: int | None = None) -> "EncoderParams":
        """Resolve parameter dependencies (SanitizeParams + ComputeLgBlock)."""
        p = replace(self)
        p.quality = max(MIN_QUALITY, min(MAX_QUALITY, p.quality))
        if p.catable:
            p.appendable = True
        if p.bare:
            p.byte_align = True
        max_w = LARGE_MAX_WINDOW_BITS if p.large_window else MAX_WINDOW_BITS
        p.lgwin = max(MIN_WINDOW_BITS, min(max_w, p.lgwin))
        if input_size is not None and p.size_hint == 0:
            p.size_hint = input_size
        # Shrink the window for small inputs -- but never for streams
        # meant for concatenation, whose window must match across parts.
        if (input_size is not None and 0 < input_size and p.quality >= 2
                and not (p.catable or p.appendable)):
            while (p.lgwin > MIN_WINDOW_BITS
                   and (1 << (p.lgwin - 1)) - 16 >= input_size):
                p.lgwin -= 1
        p.lgblock = compute_lg_block(p)
        p.dist = replace(p.dist, large_window=p.large_window)
        return p

    @property
    def window_size(self) -> int:
        return (1 << self.lgwin) - 16

    @property
    def effective_quality(self) -> int:
        """Quality used for algorithm selection."""
        return self.quality


def compute_lg_block(p: EncoderParams) -> int:
    """Metablock input span bits: an explicit lgblock clamped to
    [16, 24], else the per-tier default (q0-1: min(lgwin, 20); q2-3:
    17; q4-9: 19, i.e. 512 KiB spans; q10+: 22)."""
    lgblock = p.lgblock
    if lgblock == 0:
        if p.quality <= 1:
            lgblock = min(p.lgwin, 20)
        elif p.quality <= 3:
            lgblock = 17
        elif p.quality <= 9:
            lgblock = 19
        else:
            lgblock = 22
    return max(MIN_INPUT_BLOCK_BITS, min(MAX_INPUT_BLOCK_BITS, lgblock))


def max_compressed_size(input_size: int) -> int:
    """Worst-case output bound (reference BrotliEncoderMaxCompressedSize):
    the input, the uncompressed metablocks' headers and 16 bytes for the
    magic number and stream header."""
    num_blocks = (input_size >> 24) + 1
    overhead = 2 + 4 * num_blocks + 3 + 1
    return input_size + overhead + 16


# settings outside the q2-q9 device path, at their defaults
_HOST_ONLY_DEFAULTS = dict(
    q9_5=False, q10_deep=False, magic_number=False,
    literal_byte_score=540, avoid_distance_prefix_search=False,
    favor_cpu_efficiency=False, num_threads=1,
    disable_literal_context_modeling=False, stream_offset=0,
    log_meta_block=False, stride_detection_quality=0,
    prior_bitmask_detection=0, literal_adaptation=(),
    use_utf8_context_mode=None)


def from_reference(ref_fields: dict) -> EncoderParams:
    """The port's EncoderParams from brotli_tpu's EncoderParams given as
    `dataclasses.asdict(...)`, for the device compress path.  A setting
    that selects behaviour outside that path (a value other than the
    field's default in _HOST_ONLY_DEFAULTS) raises, and so does an
    unknown field."""
    known = {f.name for f in fields(EncoderParams)}
    for k, v in ref_fields.items():
        if k not in known:
            raise ValueError(f"unknown encoder parameter {k!r}")
        if k in _HOST_ONLY_DEFAULTS and v != _HOST_ONLY_DEFAULTS[k]:
            raise ValueError(
                f"encoder parameter {k}={v!r} is not supported by the "
                "device compress path")
    kw = {k: v for k, v in ref_fields.items() if k != "dist"}
    dist = DistanceParams(**ref_fields.get("dist", {}))
    return EncoderParams(**kw, dist=dist)
