"""The C API's shape (google/brotli encode.h and decode.h, the
reference's src/ffi/compressor.rs and decompressor.rs), on the host.

The port's copy of brotli_tpu/ffi.py, with the same constants, ids,
states and functions: instance create and destroy, numbered
parameters, streaming operations with has-more-output semantics,
TakeOutput, the one-shot and preallocated calls, error codes.

As in the reference FFI, every entry point catches internal errors and
returns failure instead of raising (its catch_unwind wrappers,
ffi/compressor.rs:421).
"""

from __future__ import annotations

from .decode.stream import StreamDecoder
from .encode.streaming import Compressor

# BrotliEncoderParameter (reference src/enc/parameters.rs:3-259)
BROTLI_PARAM_MODE = 0
BROTLI_PARAM_QUALITY = 1
BROTLI_PARAM_LGWIN = 2
BROTLI_PARAM_LGBLOCK = 3
BROTLI_PARAM_DISABLE_LITERAL_CONTEXT_MODELING = 4
BROTLI_PARAM_SIZE_HINT = 5
BROTLI_PARAM_LARGE_WINDOW = 6
BROTLI_PARAM_NPOSTFIX = 7
BROTLI_PARAM_NDIRECT = 8
BROTLI_PARAM_STREAM_OFFSET = 9
# Dropbox extensions (parameters.rs:150+; ids match the reference
# enum exactly so FFI callers compiled against either header agree)
BROTLI_PARAM_Q9_5 = 150
BROTLI_PARAM_METABLOCK_CALLBACK = 151
BROTLI_PARAM_LITERAL_BYTE_SCORE = 154
BROTLI_PARAM_AVOID_DISTANCE_PREFIX_SEARCH = 166
BROTLI_PARAM_CATABLE = 167
BROTLI_PARAM_APPENDABLE = 168
BROTLI_PARAM_MAGIC_NUMBER = 169
BROTLI_PARAM_NO_DICTIONARY = 170
BROTLI_PARAM_FAVOR_EFFICIENCY = 171
BROTLI_PARAM_BYTE_ALIGN = 172
BROTLI_PARAM_BARE_STREAM = 173

# BrotliEncoderOperation (reference encode.rs:1380-1385)
BROTLI_OPERATION_PROCESS = 0
BROTLI_OPERATION_FLUSH = 1
BROTLI_OPERATION_FINISH = 2
BROTLI_OPERATION_EMIT_METADATA = 3

# BrotliDecoderResult (c/brotli/decode.h)
BROTLI_DECODER_RESULT_ERROR = 0
BROTLI_DECODER_RESULT_SUCCESS = 1
BROTLI_DECODER_RESULT_NEEDS_MORE_INPUT = 2
BROTLI_DECODER_RESULT_NEEDS_MORE_OUTPUT = 3

BROTLI_DECODER_PARAM_DISABLE_RING_BUFFER_REALLOCATION = 0
BROTLI_DECODER_PARAM_LARGE_WINDOW = 1


def BrotliEncoderVersion() -> int:
    return 0x1000000 | 1


class BrotliEncoderState:
    """Streaming encoder instance (reference
    BrotliEncoderCreateInstance)."""

    def __init__(self):
        self._params = {}
        self._compressor = None
        self._pending_out = bytearray()
        self._finished = False
        self._dictionary = b""

    # -- parameters ------------------------------------------------------
    def set_parameter(self, param: int, value: int) -> bool:
        if self._compressor is not None:
            return False  # parameters are frozen after first input
        self._params[param] = value
        return True

    def set_custom_dictionary(self, dictionary: bytes):
        self._dictionary = bytes(dictionary)

    def _ensure(self):
        if self._compressor is None:
            p = self._params
            q = p.get(BROTLI_PARAM_QUALITY, 11)
            if p.get(BROTLI_PARAM_Q9_5, 0) and q < 10:
                q = 10  # the 9.5 family rides the q10 tier
            self._compressor = Compressor(
                quality=q,
                lgblock=p.get(BROTLI_PARAM_LGBLOCK, 0),
                lgwin=p.get(BROTLI_PARAM_LGWIN, 22),
                mode=p.get(BROTLI_PARAM_MODE, 0),
                catable=bool(p.get(BROTLI_PARAM_CATABLE, 0)),
                appendable=bool(p.get(BROTLI_PARAM_APPENDABLE, 0)),
                byte_align=bool(p.get(BROTLI_PARAM_BYTE_ALIGN, 0)),
                magic_number=bool(p.get(BROTLI_PARAM_MAGIC_NUMBER, 0)),
                stream_offset=p.get(BROTLI_PARAM_STREAM_OFFSET, 0),
                custom_dictionary=self._dictionary)
        return self._compressor

    # -- streaming -------------------------------------------------------
    def compress_stream(self, op: int, data: bytes = b"",
                        metadata: bytes = b"") -> bool:
        try:
            c = self._ensure()
            if op == BROTLI_OPERATION_PROCESS:
                self._pending_out += c.process(data)
            elif op == BROTLI_OPERATION_FLUSH:
                self._pending_out += c.process(data)
                self._pending_out += c.flush()
            elif op == BROTLI_OPERATION_FINISH:
                self._pending_out += c.process(data)
                self._pending_out += c.finish()
                self._finished = True
            elif op == BROTLI_OPERATION_EMIT_METADATA:
                self._pending_out += c.emit_metadata(metadata)
            else:
                return False
            return True
        except Exception:
            return False

    def has_more_output(self) -> bool:
        return len(self._pending_out) > 0

    def take_output(self, max_bytes: int | None = None) -> bytes:
        if max_bytes is None:
            out = bytes(self._pending_out)
            self._pending_out.clear()
        else:
            out = bytes(self._pending_out[:max_bytes])
            del self._pending_out[:max_bytes]
        return out

    def is_finished(self) -> bool:
        return self._finished and not self._pending_out


def BrotliEncoderCreateInstance() -> BrotliEncoderState:
    return BrotliEncoderState()


def BrotliEncoderDestroyInstance(state: BrotliEncoderState):
    state._pending_out.clear()
    state._compressor = None


def BrotliEncoderSetParameter(state, param, value) -> bool:
    return state.set_parameter(param, value)


def BrotliEncoderSetCustomDictionary(state, dictionary: bytes):
    state.set_custom_dictionary(dictionary)


def BrotliEncoderMaxCompressedSize(input_size: int) -> int:
    from .encode.params import max_compressed_size
    return max_compressed_size(input_size)


def BrotliEncoderCompress(quality: int, lgwin: int, mode: int,
                          data: bytes):
    """One-shot (reference BrotliEncoderCompress).  Returns the
    compressed bytes or None on failure."""
    try:
        from . import compress
        return compress(data, quality=quality, lgwin=lgwin, mode=mode)
    except Exception:
        return None


def BrotliEncoderCompressPrealloc(quality: int, lgwin: int, mode: int,
                                  data: bytes, scratch=None):
    """Fully-preallocated encode (reference stack-allocator mode,
    combined_alloc.rs): q0-q9, all big scratch (fragment tables OR the
    ring-tier session buffers) from the caller's arena, zero heap
    allocations after BrotliEncoderPreallocWarmup.  Returns the
    compressed bytes or None (unsupported quality / arena too
    small)."""
    import ctypes

    from . import native_bridge as nb
    if not nb.available():
        return None
    need = nb.prealloc_scratch_size(len(data), quality)
    if scratch is None:
        scratch = ctypes.create_string_buffer(need)
    elif len(scratch) < need:
        return None
    return nb.compress_prealloc(quality, lgwin, mode, data, scratch)


def BrotliEncoderCompressStream(state, op, data=b"",
                                metadata=b"") -> bool:
    return state.compress_stream(op, data, metadata)


def BrotliEncoderHasMoreOutput(state) -> bool:
    return state.has_more_output()


def BrotliEncoderTakeOutput(state, max_bytes=None) -> bytes:
    return state.take_output(max_bytes)


def BrotliEncoderIsFinished(state) -> bool:
    return state.is_finished()


def BrotliEncoderCompressMulti(data: bytes, num_threads: int,
                               quality: int = 9, lgwin: int = 22):
    """Reference BrotliEncoderCompressMulti
    (ffi/multicompress/mod.rs:93)."""
    try:
        from . import compress_multi
        return compress_multi(data, num_threads, quality=quality,
                              lgwin=lgwin)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Decoder side (CBrotliDecoder*, reference ffi/decompressor.rs)
# ---------------------------------------------------------------------------


class BrotliDecoderState:
    def __init__(self):
        self._params = {}
        self._decoder = None
        self._pending_out = bytearray()
        self._error = None
        self._dictionary = b""

    def set_parameter(self, param: int, value: int) -> bool:
        self._params[param] = value
        return True

    def set_custom_dictionary(self, dictionary: bytes):
        self._dictionary = bytes(dictionary)

    def _ensure(self):
        if self._decoder is None:
            large = bool(self._params.get(
                BROTLI_DECODER_PARAM_LARGE_WINDOW, 0))
            self._decoder = StreamDecoder(self._dictionary, large)
        return self._decoder

    def decompress_stream(self, data: bytes) -> int:
        try:
            d = self._ensure()
            self._pending_out += d.decompress(data)
            if d.finished:
                return BROTLI_DECODER_RESULT_SUCCESS
            return BROTLI_DECODER_RESULT_NEEDS_MORE_INPUT
        except Exception as e:
            self._error = e
            return BROTLI_DECODER_RESULT_ERROR

    def has_more_output(self) -> bool:
        return len(self._pending_out) > 0

    def take_output(self, max_bytes=None) -> bytes:
        if max_bytes is None:
            out = bytes(self._pending_out)
            self._pending_out.clear()
        else:
            out = bytes(self._pending_out[:max_bytes])
            del self._pending_out[:max_bytes]
        return out

    def is_finished(self) -> bool:
        d = self._decoder
        return d is not None and d.finished and not self._pending_out

    def is_used(self) -> bool:
        return self._decoder is not None

    def get_error_code(self) -> int:
        return -1 if self._error else 0

    def error_string(self) -> str:
        return str(self._error) if self._error else "NO_ERROR"


def BrotliDecoderCreateInstance() -> BrotliDecoderState:
    return BrotliDecoderState()


def BrotliDecoderDestroyInstance(state):
    state._pending_out.clear()
    state._decoder = None


def BrotliDecoderSetParameter(state, param, value) -> bool:
    return state.set_parameter(param, value)


def BrotliDecoderSetCustomDictionary(state, dictionary: bytes):
    state.set_custom_dictionary(dictionary)


def BrotliDecoderDecompress(data: bytes):
    """One-shot decode; returns bytes or None (reference
    CBrotliDecoderDecompress)."""
    try:
        from . import decompress
        return decompress(data)
    except Exception:
        return None


class BrotliDecoderReturnInfo:
    """Mirror of BrotliDecoderReturnInfoStruct
    (reference c/brotli/decode.h:128-133)."""

    def __init__(self, decoded_size=0, error="", result=0, code=0):
        self.decoded_size = decoded_size
        self.error = error
        self.result = result
        self.code = code


def BrotliDecoderDecompressWithReturnInfo(data: bytes, decoded_buffer
                                          ) -> BrotliDecoderReturnInfo:
    """Decode into a caller-provided writable buffer (bytearray /
    memoryview / numpy u8), returning size + result + error detail
    instead of raising (reference decode.h:223-227)."""
    from . import native_bridge
    try:
        if native_bridge.available():
            n = native_bridge.decode_into(data, decoded_buffer)
        else:
            from .decode.decoder import decompress as _py_decompress
            out = _py_decompress(bytes(data))
            if len(out) > len(memoryview(decoded_buffer)):
                raise BufferError("output buffer too small")
            memoryview(decoded_buffer)[:len(out)] = out
            n = len(out)
        return BrotliDecoderReturnInfo(
            decoded_size=n, result=BROTLI_DECODER_RESULT_SUCCESS)
    except BufferError as e:
        return BrotliDecoderReturnInfo(
            error=str(e), result=BROTLI_DECODER_RESULT_ERROR, code=-1)
    except Exception as e:
        return BrotliDecoderReturnInfo(
            error=str(e)[:255], result=BROTLI_DECODER_RESULT_ERROR,
            code=-2)


def BrotliDecoderDecompressPrealloc(data: bytes, decoded_buffer
                                    ) -> BrotliDecoderReturnInfo:
    """Allocation-free decode into a preallocated buffer (reference
    decode.h:229-237).  The native runtime reuses a shared table arena,
    so no per-call scratch parameters are needed."""
    return BrotliDecoderDecompressWithReturnInfo(data, decoded_buffer)


def BrotliDecoderDecompressStream(state, data: bytes) -> int:
    return state.decompress_stream(data)


def BrotliDecoderHasMoreOutput(state) -> bool:
    return state.has_more_output()


def BrotliDecoderTakeOutput(state, max_bytes=None) -> bytes:
    return state.take_output(max_bytes)


def BrotliDecoderIsFinished(state) -> bool:
    return state.is_finished()


def BrotliDecoderIsUsed(state) -> bool:
    return state.is_used()


def BrotliDecoderGetErrorCode(state) -> int:
    return state.get_error_code()


def BrotliDecoderErrorString(state) -> str:
    return state.error_string()


def BrotliDecoderVersion() -> int:
    return 0x1000000 | 1
