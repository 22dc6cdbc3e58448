"""Native rANS entropy coder (the port's own copy, bound via ctypes).

Same Python surface as `stf_tpu.ans`:

    BufferedRansEncoder  .encode_with_indexes(...) [buffers] / .flush() -> bytes
    RansEncoder          .encode_with_indexes(...) -> bytes (one-shot)
    RansDecoder          .decode_with_indexes(...) -> np.ndarray[int32]
                         .set_stream(bytes) / .decode_stream(...) -> np.ndarray

plus the range-coder twins, ``pmf_to_quantized_cdf_rows`` and the native
lane encoder ``lane_encode_groups``.
"""

from ._binding import (
    BufferedRangeEncoder,
    BufferedRansEncoder,
    RangeDecoder,
    RangeEncoder,
    RansDecoder,
    RansEncoder,
    lane_encode_groups,
    pmf_to_quantized_cdf_rows,
)

# host entropy backends by registry name (stf_tpu_torch.set_entropy_coder):
# same symbol protocol, different bit layers — streams are NOT
# interoperable between backends.
_HOST_CODERS = {
    "rans": (BufferedRansEncoder, RansEncoder, RansDecoder),
    "rangecoder": (BufferedRangeEncoder, RangeEncoder, RangeDecoder),
}


def resolve_host_backend(name=None) -> str:
    """Validated host-backend name; `None` resolves to the package-level
    selection (`stf_tpu_torch.get_entropy_coder()`). Long-lived objects
    (the Codec, the entropy-model coders) snapshot this at construction so
    a later registry flip can't decode a stream with the wrong bit layer."""
    if name is None:
        import stf_tpu_torch

        name = stf_tpu_torch.get_entropy_coder()
    if name not in _HOST_CODERS:
        raise ValueError(
            f"unknown host entropy coder {name!r} "
            f"(available: {', '.join(_HOST_CODERS)})"
        )
    return name


def host_coder_classes(name=None):
    """(BufferedEncoder, Encoder, Decoder) classes for the named host
    entropy backend; with no name, follows the package-level selection."""
    return _HOST_CODERS[resolve_host_backend(name)]


__all__ = [
    "BufferedRansEncoder",
    "RansEncoder",
    "RansDecoder",
    "BufferedRangeEncoder",
    "RangeEncoder",
    "RangeDecoder",
    "host_coder_classes",
    "lane_encode_groups",
    "resolve_host_backend",
    "pmf_to_quantized_cdf_rows",
]
