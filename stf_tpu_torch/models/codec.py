"""Codec runner: real bitstream compress/decompress (port of the per-slice
walk of `stf_tpu/models/codec.py`).

Work split:
  * device: transforms, context models, quantization, scale-table indexes,
    and (coder="lane") the y decode through kernel B2;
  * host: the factorized rANS coder for z, and for y either the
    reference-contract rANS coder (coder="host") or the native lane
    encoder (coder="lane").

Lockstep: compress and decompress call the same model methods at the same
shapes (`_walk_slices`), so every mu, scale and index is bit-identical on
both sides; a flipped scale index would desynchronize the stream. On CUDA
the constructor fixes one numerical policy for that: cuDNN deterministic
with benchmarking off, and no TF32 in matmuls or convolutions. Neither
kernel uses atomics. The lane stream carries a hash of every slice's
encoder-side indexes; the decoder recomputes them and raises on a
mismatch.

Stream layout matches the JAX codec at pipeline=1: host y-streams are per
image (slices 0..S-1 in NHWC C-order); the lane y-stream is the u32 header
0x4C414E00, S u32 index hashes, then the packed lane segments, one per
slice. Left out of this port so far: fused tiers, device_encode, the
packed drain, pipeline > 1, analyze/synth chunks and bf16 transforms.
"""

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ans import host_coder_classes, lane_coder as lc, resolve_host_backend
from ..entropy import (
    EntropyBottleneckCoder,
    GaussianConditionalCoder,
    build_eb_tables,
    build_gc_tables,
    get_scale_table,
)

_HASH_MUL = 2654435761
_HASH_ADD = 97531
_LANE_HEADER_MAGIC = 0x4C414E00


def _bucket(rows: int, minimum: int = 8) -> int:
    """Round a row count up to a power of two (quantizes the decoder's
    stream-bank allocations)."""
    b = minimum
    while b < rows:
        b <<= 1
    return b


def idx_hash(idx_flat: torch.Tensor) -> torch.Tensor:
    """Position-weighted hash of a flat scale-index tensor, mod 2^32: the
    JAX codec's uint32 hash, computed in int64 and masked."""
    i = torch.arange(idx_flat.numel(), dtype=torch.int64, device=idx_flat.device)
    w = (i * _HASH_MUL + _HASH_ADD) & 0xFFFFFFFF
    return (idx_flat.reshape(-1).to(torch.int64) * w).sum() & 0xFFFFFFFF


def _nhwc_flat(t: torch.Tensor) -> torch.Tensor:
    """NCHW -> flat NHWC C-order (the streams' symbol order)."""
    return t.permute(0, 2, 3, 1).reshape(-1)


def default_device() -> torch.device:
    """The card; raises when there is none (the port never falls back)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: stf_tpu_torch runs on the GPU; pass "
            "device='cpu' explicitly to run the plain versions on the CPU"
        )
    return torch.device("cuda")


class Codec:
    """Wraps a model with CDF tables and the coding walk.

    `coder` picks the y-latent entropy backend: "host" (reference-contract
    rANS on the CPU) or "lane" (native lane encoder; the decoder runs
    kernel B2 per slice on the device). z always uses the host factorized
    coder. `device=None` means CUDA.
    """

    def __init__(self, model, scale_table: Optional[np.ndarray] = None,
                 coder: str = "host", device=None):
        if coder not in ("host", "lane"):
            raise ValueError(f"unknown entropy coder {coder!r}")
        self.coder = coder
        self.device = default_device() if device is None else torch.device(device)
        # one fixed numerical policy, so encoder and decoder agree bitwise
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device).eval()
        self.scale_table = (
            np.asarray(scale_table, np.float32)
            if scale_table is not None
            else get_scale_table()
        )
        # pin the host entropy backend for this codec's lifetime
        self.host_backend = resolve_host_backend()
        self.update()

    # -- table refresh (reference `update()`) --------------------------------

    def update(self, scale_table: Optional[np.ndarray] = None) -> bool:
        if scale_table is not None:
            self.scale_table = np.asarray(scale_table, np.float32)
        self._table = torch.from_numpy(self.scale_table).to(self.device)
        eb = self.model.entropy_bottleneck
        medians = eb.medians()
        self._medians = medians.to(self.device)[None, :, None, None]
        self.eb_coder = EntropyBottleneckCoder(
            build_eb_tables(eb), medians.cpu().numpy(),
            backend=self.host_backend,
        )
        self.gc_coder = GaussianConditionalCoder(
            build_gc_tables(self.scale_table), self.scale_table,
            backend=self.host_backend,
        )
        if self.coder == "lane":
            # rows clamped to ±62 symbols (W = 127), as the JAX codec does;
            # out-of-window values ride the side channel
            self.lane_tables = lc.truncate_tables(
                *self.gc_coder.tables.astuple(), max_half=62
            )
            self._lane_dev_tables = lc.table_tensors(
                self.lane_tables, self.device
            )
        return True

    # -- shared pieces --------------------------------------------------------

    def _z_dequantize(self, z_sym: torch.Tensor) -> torch.Tensor:
        """z_hat = symbols + medians in f32: the same op on both sides."""
        return z_sym.to(torch.float32) + self._medians

    def _walk_slices(self, latent_means, latent_scales, get_symbols):
        """The channel-AR slice chain. `get_symbols(i, mu, idx)` returns the
        int32 NCHW symbols of slice i, from quantization (encoder) or from
        the stream (decoder). Both sides run exactly this walk."""
        model, table = self.model, self._table
        k = model.max_support_slices
        y_hat_slices: List = []

        def support():
            return tuple(y_hat_slices if k < 0 else y_hat_slices[:k])

        mu, idx = model.decode_slice_indexes(
            0, latent_means, latent_scales, (), table
        )
        for i in range(1, model.num_slices):
            rv = get_symbols(i - 1, mu, idx)
            y_prev, mu, idx = model.decode_slice_fused(
                i, latent_means, latent_scales, support(), mu, rv, table
            )
            y_hat_slices.append(y_prev)
        rv = get_symbols(model.num_slices - 1, mu, idx)
        y_hat_slices.append(model.decode_slice_apply(
            model.num_slices - 1, latent_means, support(), mu, rv
        ))
        return y_hat_slices

    def _to_device_image(self, x) -> torch.Tensor:
        """(B, H, W, 3) uint8 or float image -> NCHW f32 on the device;
        uint8 normalizes on the device (1 byte/pixel crosses)."""
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(self.device)
        x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.float()
        return x.permute(0, 3, 1, 2).contiguous()

    # -- compress ------------------------------------------------------------

    @torch.inference_mode()
    def compress(self, x) -> Dict[str, Any]:
        """x: (B, H, W, 3) uint8 or float in [0, 1]. Returns the strings,
        the z spatial shape, and the per-slice NHWC int32 symbols and
        indexes that were coded."""
        model = self.model
        y, z = model.analyze(self._to_device_image(x))
        z_sym = torch.round(z - self._medians).to(torch.int32)
        z_hat = self._z_dequantize(z_sym)
        latent_means, latent_scales = model.hyper_synthesize(
            z_hat, (y.shape[2], y.shape[3])
        )
        y_slices = model.split_slices(y)
        symbols, indexes = [], []

        def get_symbols(i, mu, idx):
            q = torch.round(y_slices[i] - mu).to(torch.int32)
            symbols.append(q)
            indexes.append(idx)
            return q

        self._walk_slices(latent_means, latent_scales, get_symbols)
        nhwc = lambda t: t.permute(0, 2, 3, 1).cpu().numpy()  # noqa: E731
        sym_np = [nhwc(q) for q in symbols]
        idx_np = [nhwc(i) for i in indexes]

        if self.coder == "lane":
            hashes = torch.stack(
                [idx_hash(_nhwc_flat(i)) for i in indexes]
            ).cpu().numpy()
            segments = [
                lc.lane_encode(s.reshape(-1), i.reshape(-1), self.lane_tables)
                for s, i in zip(sym_np, idx_np)
            ]
            y_strings = [
                np.asarray([_LANE_HEADER_MAGIC], "<u4").tobytes()
                + hashes.astype("<u4").tobytes()
                + lc.pack_lane_stream(segments)
            ]
        else:
            # per-image streams, slices 0..S-1 (the JAX host layout)
            cdf, lengths, offsets = self.gc_coder.tables.astuple()
            encoders = [
                host_coder_classes(self.host_backend)[0]()
                for _ in range(y.shape[0])
            ]
            for s, i in zip(sym_np, idx_np):
                for b, enc in enumerate(encoders):
                    enc.encode_with_indexes(
                        s[b].reshape(-1), i[b].reshape(-1),
                        cdf, lengths, offsets,
                    )
            y_strings = [e.flush() for e in encoders]

        z_strings = self.eb_coder.compress_symbols(nhwc(z_sym))
        return {
            "strings": [y_strings, z_strings],
            "shape": (z.shape[2], z.shape[3]),
            "symbols": sym_np,
            "indexes": idx_np,
        }

    # -- decompress ----------------------------------------------------------

    def _lane_segments(self, blob: bytes, S: int):
        """Parse a lane y-stream: (encoder index hashes, segments)."""
        if len(blob) < 4 + 4 * S:
            raise ValueError(
                f"lane y-stream is {len(blob)} bytes — shorter than its "
                f"{4 + 4 * S}-byte header (truncated, or not a lane stream)"
            )
        header = int(np.frombuffer(blob[:4], "<u4")[0])
        if (header & 0xFFFFFF00) != _LANE_HEADER_MAGIC:
            raise ValueError(
                f"lane y-stream header 0x{header:08x} does not carry magic "
                f"0x{_LANE_HEADER_MAGIC:08x}"
            )
        hashes = np.frombuffer(blob[4 : 4 + 4 * S], "<u4").astype(np.int64)
        segments = lc.unpack_lane_stream(blob[4 + 4 * S :])
        if len(segments) != S:
            raise ValueError(
                f"lane stream has {len(segments)} segments, expected {S} "
                "(num_slices mismatch, or a pipeline > 1 stream)"
            )
        return hashes, segments

    def _upload_segment(self, seg):
        wr = _bucket(lc.words_rows_for(seg.word_counts.max()))
        sr = _bucket(lc.side_rows_for(seg.side_counts.max()))
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return (
            put(lc.pack_word_banks(seg, wr)),
            put(lc.pad_side_banks(seg, sr)),
            lc.states_tensor(seg, self.device),
        )

    @torch.inference_mode()
    def decompress(self, strings: Sequence, shape) -> Dict[str, Any]:
        """Returns the NHWC x_hat in [0, 1] and the per-slice NHWC int32
        symbols decoded (device tensors)."""
        model = self.model
        y_strings, z_strings = strings[0], strings[1]
        z_sym = self.eb_coder.decompress_symbols(z_strings, shape)
        B = z_sym.shape[0]
        S = model.num_slices
        up = model.hyper_upsample
        y_shape = (shape[0] * up, shape[1] * up)

        lane = self.coder == "lane"
        if lane:
            enc_hashes, segments = self._lane_segments(
                y_strings[0] if len(y_strings) else b"", S
            )
            banks = [self._upload_segment(seg) for seg in segments]
        else:
            if len(y_strings) != B:
                raise ValueError(
                    f"host y-streams are per image: got {len(y_strings)} "
                    f"streams for a batch of {B}"
                )
            cdf, lengths, offsets = self.gc_coder.tables.astuple()
            decoders = []
            for s in y_strings:
                d = host_coder_classes(self.host_backend)[2]()
                d.set_stream(s)
                decoders.append(d)

        z_dev = torch.from_numpy(z_sym).to(self.device).permute(0, 3, 1, 2)
        latent_means, latent_scales = model.hyper_synthesize(
            self._z_dequantize(z_dev), y_shape
        )
        dec_hashes, decoded = [], []

        def get_symbols(i, mu, idx):
            _, c, h, w = idx.shape
            idx_flat = _nhwc_flat(idx)
            n = idx_flat.numel()
            if lane:
                if segments[i].n != n:
                    raise ValueError(
                        "lane segment symbol count does not match the slice "
                        "shape"
                    )
                dec_hashes.append(idx_hash(idx_flat))
                rv = lc.lane_decode(
                    idx_flat, *banks[i], *self._lane_dev_tables, n
                )
            else:
                idx_np = idx_flat.cpu().numpy().reshape(B, -1)
                rv = torch.from_numpy(np.stack([
                    d.decode_stream(idx_np[b], cdf, lengths, offsets)
                    for b, d in enumerate(decoders)
                ])).to(self.device)
            rv = rv.reshape(B, h, w, c)
            decoded.append(rv)
            return rv.permute(0, 3, 1, 2)

        y_hat_slices = self._walk_slices(latent_means, latent_scales, get_symbols)
        if lane:
            got = torch.stack(dec_hashes).cpu().numpy()
            if not np.array_equal(got, enc_hashes):
                bad = np.flatnonzero(got != enc_hashes).tolist()
                raise ValueError(
                    "lane decode derived different scale indexes than the "
                    f"encoder (index hash mismatch in slices {bad}); the "
                    "decoded image is not valid"
                )
        x_hat = model.synthesize(torch.cat(y_hat_slices, dim=1))
        return {
            "x_hat": x_hat.permute(0, 2, 3, 1).contiguous(),
            "symbols": decoded,
        }
