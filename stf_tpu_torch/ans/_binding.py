"""ctypes bindings over the port's copy of the native rANS core
(``csrc/rans_coder.cpp``, built by ``stf_tpu_torch._native``); the same
bindings as ``stf_tpu/ans/_binding.py``, so streams are byte-identical.

All array arguments are passed as contiguous NumPy buffers — no Python list
round-trips (the reference's main host-side bottleneck, see
`compressai/entropy_models/entropy_models.py:227-238`).

CDF tables are 2-D int32 arrays of shape [rows, max_len]; per-row valid
lengths come from `cdf_lengths`, and `offsets` holds the per-row symbol
offset. These have identical semantics to the reference coder's arguments.
"""

import ctypes

import numpy as np

from .._native import build_all, library_path

try:
    _lib = ctypes.CDLL(build_all(["rans"])["rans"])
except OSError:
    # stale/foreign binary (different arch or libc): force a rebuild
    build_all(["rans"], force=True)
    _lib = ctypes.CDLL(library_path("rans"))

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_f32p = ctypes.POINTER(ctypes.c_float)

_lib.stf_encoder_new.restype = ctypes.c_void_p
_lib.stf_encoder_free.argtypes = [ctypes.c_void_p]
_lib.stf_encoder_buffer.argtypes = [
    ctypes.c_void_p, _i32p, _i32p, ctypes.c_int64,
    _i32p, ctypes.c_int64, _i32p, _i32p,
]
_lib.stf_encoder_flush.restype = ctypes.c_int64
_lib.stf_encoder_flush.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_int64]
_lib.stf_encoder_bound.restype = ctypes.c_int64
_lib.stf_encoder_bound.argtypes = [ctypes.c_void_p]

_lib.stf_decode_with_indexes.restype = ctypes.c_int64
_lib.stf_decode_with_indexes.argtypes = [
    _u8p, ctypes.c_int64, _i32p, ctypes.c_int64,
    _i32p, ctypes.c_int64, _i32p, _i32p, _i32p,
]

_lib.stf_decoder_new.restype = ctypes.c_void_p
_lib.stf_decoder_free.argtypes = [ctypes.c_void_p]
_lib.stf_decoder_set_stream.restype = ctypes.c_int32
_lib.stf_decoder_set_stream.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_int64]
_lib.stf_decoder_decode_stream.restype = ctypes.c_int64
_lib.stf_decoder_decode_stream.argtypes = [
    ctypes.c_void_p, _i32p, ctypes.c_int64,
    _i32p, ctypes.c_int64, _i32p, _i32p, _i32p,
]

_i64p = ctypes.POINTER(ctypes.c_int64)
_u16p = ctypes.POINTER(ctypes.c_uint16)

# range-coder backend (same symbol protocol, forward byte-wise bit layer)
_lib.stf_rc_encoder_flush.restype = ctypes.c_int64
_lib.stf_rc_encoder_flush.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_int64]
_lib.stf_rc_decode_with_indexes.restype = ctypes.c_int64
_lib.stf_rc_decode_with_indexes.argtypes = [
    _u8p, ctypes.c_int64, _i32p, ctypes.c_int64,
    _i32p, ctypes.c_int64, _i32p, _i32p, _i32p,
]
_lib.stf_rc_decoder_new.restype = ctypes.c_void_p
_lib.stf_rc_decoder_free.argtypes = [ctypes.c_void_p]
_lib.stf_rc_decoder_set_stream.restype = ctypes.c_int32
_lib.stf_rc_decoder_set_stream.argtypes = [
    ctypes.c_void_p, _u8p, ctypes.c_int64,
]
_lib.stf_rc_decoder_decode_stream.restype = ctypes.c_int64
_lib.stf_rc_decoder_decode_stream.argtypes = [
    ctypes.c_void_p, _i32p, ctypes.c_int64,
    _i32p, ctypes.c_int64, _i32p, _i32p, _i32p,
]

_lib.stf_lane_encode.restype = ctypes.c_int32
_lib.stf_lane_encode.argtypes = [
    _i32p, _i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    _i32p, ctypes.c_int64, _i32p, _i32p,
    _u16p, _i64p, _u32p, _i32p, _i64p,
]

_lib.stf_pmf_to_quantized_cdf_rows.restype = ctypes.c_int32
_lib.stf_pmf_to_quantized_cdf_rows.argtypes = [
    _f32p, ctypes.c_int64, _f32p, _i32p, ctypes.c_int64,
    ctypes.c_int32, _i32p, ctypes.c_int64,
]


def _as_i32(a):
    return np.ascontiguousarray(np.asarray(a).reshape(-1), dtype=np.int32)


def _as_cdf_table(cdfs):
    arr = np.ascontiguousarray(np.asarray(cdfs), dtype=np.int32)
    if arr.ndim != 2:
        raise ValueError(f"CDF table must be 2-D, got shape {arr.shape}")
    return arr


def _i32_ptr(a):
    return a.ctypes.data_as(_i32p)


def _check_indexes(indexes, cdfs):
    """Out-of-range CDF row indexes would make the native CdfView read out
    of bounds (crash/garbage); raise a Python error instead."""
    if indexes.size and (indexes.min() < 0 or indexes.max() >= cdfs.shape[0]):
        raise ValueError("index out of range of the CDF table")


class BufferedRansEncoder:
    """Accumulates symbols across calls, then encodes them all in one flush.

    Matches the reference's buffered encoder protocol
    (`rans_interface.cpp:99-191`): models buffer all channel-AR slices'
    symbols and flush once so the whole latent shares one rANS stream.
    """

    def __init__(self):
        self._handle = _lib.stf_encoder_new()

    def __del__(self, _free=_lib.stf_encoder_free):
        if getattr(self, "_handle", None):
            _free(self._handle)
            self._handle = None

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_lengths, offsets):
        symbols = _as_i32(symbols)
        indexes = _as_i32(indexes)
        if symbols.size != indexes.size:
            raise ValueError("symbols and indexes must have the same length")
        cdfs = _as_cdf_table(cdfs)
        cdf_lengths = _as_i32(cdf_lengths)
        offsets = _as_i32(offsets)
        _check_indexes(indexes, cdfs)
        _lib.stf_encoder_buffer(
            self._handle,
            _i32_ptr(symbols), _i32_ptr(indexes), symbols.size,
            _i32_ptr(cdfs), cdfs.shape[1], _i32_ptr(cdf_lengths),
            _i32_ptr(offsets),
        )

    def flush(self) -> bytes:
        cap = _lib.stf_encoder_bound(self._handle)
        out = np.empty(max(cap, 8), dtype=np.uint8)
        n = _lib.stf_encoder_flush(self._handle, out.ctypes.data_as(_u8p), out.size)
        if n < 0:
            raise RuntimeError("rANS flush failed (buffer too small)")
        return out[:n].tobytes()


class RansEncoder:
    """One-shot encoder: buffer + flush in a single call."""

    def encode_with_indexes(
        self, symbols, indexes, cdfs, cdf_lengths, offsets
    ) -> bytes:
        enc = BufferedRansEncoder()
        enc.encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets)
        return enc.flush()


class _HostDecoder:
    """Stateless (`decode_with_indexes`) and streaming (`set_stream` +
    `decode_stream`) decoding; the streaming form drives autoregressive
    slice-by-slice decode. Subclasses bind one backend's native entry
    points (class attributes, so both bit layers share one protocol
    implementation and can't drift)."""

    # subclass bindings: native ctors/entry points + display name
    _c_new = _c_free = _c_decode = _c_set_stream = _c_decode_stream = None
    _layer = "?"

    def __init__(self):
        self._handle = type(self)._c_new()

    def __del__(self):
        # class-attribute lookup keeps the free fn reachable at interpreter
        # shutdown (the instance holds its class alive), like the
        # default-arg idiom the encoders use
        free = type(self)._c_free
        if getattr(self, "_handle", None) and free is not None:
            free(self._handle)
            self._handle = None

    def decode_with_indexes(
        self, stream: bytes, indexes, cdfs, cdf_lengths, offsets
    ) -> np.ndarray:
        indexes = _as_i32(indexes)
        cdfs = _as_cdf_table(cdfs)
        cdf_lengths = _as_i32(cdf_lengths)
        offsets = _as_i32(offsets)
        _check_indexes(indexes, cdfs)
        buf = np.frombuffer(stream, dtype=np.uint8)
        out = np.empty(indexes.size, dtype=np.int32)
        n = type(self)._c_decode(
            buf.ctypes.data_as(_u8p), buf.size,
            _i32_ptr(indexes), indexes.size,
            _i32_ptr(cdfs), cdfs.shape[1], _i32_ptr(cdf_lengths),
            _i32_ptr(offsets), _i32_ptr(out),
        )
        if n < 0:
            raise RuntimeError(f"invalid {self._layer} stream")
        return out

    def set_stream(self, stream: bytes) -> None:
        buf = np.frombuffer(stream, dtype=np.uint8)
        rc = type(self)._c_set_stream(
            self._handle, buf.ctypes.data_as(_u8p), buf.size
        )
        if rc != 0:
            raise RuntimeError(f"invalid {self._layer} stream")

    def decode_stream(self, indexes, cdfs, cdf_lengths, offsets) -> np.ndarray:
        indexes = _as_i32(indexes)
        cdfs = _as_cdf_table(cdfs)
        cdf_lengths = _as_i32(cdf_lengths)
        offsets = _as_i32(offsets)
        _check_indexes(indexes, cdfs)
        out = np.empty(indexes.size, dtype=np.int32)
        n = type(self)._c_decode_stream(
            self._handle,
            _i32_ptr(indexes), indexes.size,
            _i32_ptr(cdfs), cdfs.shape[1], _i32_ptr(cdf_lengths),
            _i32_ptr(offsets), _i32_ptr(out),
        )
        if n < 0:
            raise RuntimeError("decode_stream called before set_stream")
        return out


class RansDecoder(_HostDecoder):
    """rANS bit-layer decoder (reference stream contract)."""

    _c_new = _lib.stf_decoder_new
    _c_free = _lib.stf_decoder_free
    _c_decode = _lib.stf_decode_with_indexes
    _c_set_stream = _lib.stf_decoder_set_stream
    _c_decode_stream = _lib.stf_decoder_decode_stream
    _layer = "rANS"


class BufferedRangeEncoder(BufferedRansEncoder):
    """Range-coder twin of BufferedRansEncoder: identical symbol protocol
    and buffering API, forward byte-wise bit layer (the reference's
    optional "rangecoder" backend, `compressai/__init__.py:22-62`).
    Streams are NOT interoperable between the two backends."""

    def flush(self) -> bytes:
        cap = _lib.stf_encoder_bound(self._handle)
        out = np.empty(max(cap, 8), dtype=np.uint8)
        n = _lib.stf_rc_encoder_flush(
            self._handle, out.ctypes.data_as(_u8p), out.size
        )
        if n < 0:
            raise RuntimeError("range-coder flush failed (buffer too small)")
        return out[:n].tobytes()


class RangeEncoder:
    """One-shot range-coder encoder (API twin of RansEncoder)."""

    def encode_with_indexes(
        self, symbols, indexes, cdfs, cdf_lengths, offsets
    ) -> bytes:
        enc = BufferedRangeEncoder()
        enc.encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets)
        return enc.flush()


class RangeDecoder(_HostDecoder):
    """Range-coder bit-layer decoder (API twin of RansDecoder)."""

    _c_new = _lib.stf_rc_decoder_new
    _c_free = _lib.stf_rc_decoder_free
    _c_decode = _lib.stf_rc_decode_with_indexes
    _c_set_stream = _lib.stf_rc_decoder_set_stream
    _c_decode_stream = _lib.stf_rc_decoder_decode_stream
    _layer = "range-coder"


def lane_encode_groups(symbols, indexes, tg, groups, lanes,
                       cdfs, cdf_lengths, offsets):
    """Native interleaved lane-rANS encoder (`stf_lane_encode`): encodes
    `groups` independent segments of tg*lanes pre-padded symbols. Returns
    (words u16, word_counts i64[G], states u32[G, lanes], side i32,
    side_counts i64[G]) — bit-exact with lane_coder's NumPy encoder."""
    symbols = _as_i32(symbols)
    indexes = _as_i32(indexes)
    total = groups * tg * lanes
    if symbols.size != total or indexes.size != total:
        raise ValueError("lane encode needs pre-padded groups*tg*lanes input")
    cdfs = _as_cdf_table(cdfs)
    cdf_lengths = _as_i32(cdf_lengths)
    offsets = _as_i32(offsets)
    _check_indexes(indexes, cdfs)
    words = np.empty(max(total, 1), dtype=np.uint16)
    word_counts = np.zeros(groups, dtype=np.int64)
    states = np.empty((groups, lanes), dtype=np.uint32)
    side = np.empty(max(total, 1), dtype=np.int32)
    side_counts = np.zeros(groups, dtype=np.int64)
    rc = _lib.stf_lane_encode(
        _i32_ptr(symbols), _i32_ptr(indexes), tg, groups, lanes,
        _i32_ptr(cdfs), cdfs.shape[1], _i32_ptr(cdf_lengths),
        _i32_ptr(offsets),
        words.ctypes.data_as(_u16p),
        word_counts.ctypes.data_as(_i64p),
        states.ctypes.data_as(_u32p),
        _i32_ptr(side),
        side_counts.ctypes.data_as(_i64p),
    )
    if rc != 0:
        raise RuntimeError("lane encode failed (bad table index)")
    return (
        words[: int(word_counts.sum())].copy(),
        word_counts,
        states,
        side[: int(side_counts.sum())].copy(),
        side_counts,
    )


def pmf_to_quantized_cdf_rows(
    pmf, tail_mass, pmf_lengths, precision: int = 16
) -> np.ndarray:
    """Batched CDF build: `pmf` is [rows, max_pmf_len]; row i uses its first
    `pmf_lengths[i]` entries plus `tail_mass[i]` as a final bypass symbol.
    Returns an int32 table [rows, max_pmf_len + 2] (rows padded with zeros).

    Replaces the reference's per-channel Python loop
    (`entropy_models.py:172-180`) with one native call.
    """
    pmf = np.ascontiguousarray(np.asarray(pmf), dtype=np.float32)
    if pmf.ndim != 2:
        raise ValueError("pmf must be 2-D [rows, max_len]")
    tail_mass = np.ascontiguousarray(
        np.asarray(tail_mass).reshape(-1), dtype=np.float32
    )
    pmf_lengths = _as_i32(pmf_lengths)
    rows = pmf.shape[0]
    if tail_mass.size != rows or pmf_lengths.size != rows:
        raise ValueError("tail_mass / pmf_lengths must have one entry per row")
    if pmf_lengths.size and pmf_lengths.max() > pmf.shape[1]:
        raise ValueError("pmf_lengths exceed the PMF row width")
    out = np.zeros((rows, pmf.shape[1] + 2), dtype=np.int32)
    rc = _lib.stf_pmf_to_quantized_cdf_rows(
        pmf.ctypes.data_as(_f32p), pmf.shape[1],
        tail_mass.ctypes.data_as(_f32p), _i32_ptr(pmf_lengths), rows,
        precision, _i32_ptr(out), out.shape[1],
    )
    if rc != 0:
        raise RuntimeError("pmf_to_quantized_cdf_rows failed")
    return out
