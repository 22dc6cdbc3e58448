"""Codec runner: real bitstream compress/decompress (port of
`stf_tpu/models/codec.py`).

Work split:
  * device: transforms, context models, quantization, scale-table indexes,
    and (coder="lane") the y encode through kernel B3 and the y decode
    through kernel B2;
  * host: the factorized rANS coder for z, the reference-contract rANS
    coder for y (coder="host"), and the native lane encoder for a lane
    segment whose escape side channel overflowed in B3.

Lockstep: compress and decompress call the same model methods at the same
shapes (`_walk_slices`), so every mu, scale and index is bit-identical on
both sides; a flipped scale index would desynchronize the stream. On CUDA
the constructor fixes one numerical policy for that: cuDNN deterministic
with benchmarking off, no TF32 in matmuls or convolutions, and bf16
products summed in f32. No kernel uses atomics. The lane stream carries a
hash of every segment's encoder-side indexes; every decode path
recomputes them.

Lane decompress is fused by default, as in the JAX codec: one upload of
the whole stream and one CUDA-graph replay of hyper synthesis, the walk
(B2 per slice, every operand pinned by kernel B4 where the JAX fused walk
pins it) and synthesis; at pipeline > 1 the synthesis replays as a second
graph, as the JAX codec's `split_synth`. A hash mismatch there warns and
falls back to the per-slice walk, which raises on its own mismatch.

Lane compress has the JAX codec's fused encode tiers (`fused_encode`):
"full" replays one CUDA graph of the whole encode (normalise, analysis, z
quantization, hyper synthesis, the walk with B3 per slice); "split" runs
analysis, z quantization and hyper synthesis eagerly, as the per-slice
compress does, and replays one graph of the walk. Their streams set the
header's fused-encode flag. The first stream of each configuration is
decoded before compress returns it; a failure demotes full -> split ->
the per-slice walk.

Stream layout matches the JAX codec's: host y-streams are per image
(slices 0..S-1 in NHWC C-order) at any pipeline; the lane y-stream is the
u32 header 0x4C414E00 (low byte: flags, bit 0 = fused encode), S x P u32
index hashes, then the packed lane segments, one per (slice, sub-batch) in
that order, P = the codec's `pipeline` (which a decoder must share, as
it shares num_slices).

The JAX codec's options, with its defaults:
  * `dtype=torch.bfloat16`: the analysis (g_a, h_a) runs in bf16 on a
    copy of the model whose float parameters, but the entropy
    bottleneck's, are rounded to bf16; z_hat, the hyper synthesis, the
    walk and the synthesis run in f32 on the same rounded weights. That is
    what the JAX codec computes: it casts those parameters to bf16 and
    the image to bf16, and flax promotes each layer to the wider of its
    input's and its parameters' dtypes, so only the layers fed the bf16
    image stay in bf16. The caller's model is left as it is;
  * `pipeline=P`: the batch's walk runs as P sub-batch walks (1 when P
    does not divide the batch), the hyper synthesis at the full batch;
  * `pack_drain`: the host coder drains (q, idx) at 12 bits a symbol
    (on by default for tables of at most 64 levels);
  * `analyze_chunks` / `synth_chunks`: the analysis and the synthesis
    run the batch in that many sequential sub-batches (none when the
    count does not divide the batch);
  * `compress(x, probe=None, prefetch=None)` and `decompress(strings,
    shape, probe=None)`: `probe(name, tensor or None)` at each phase
    boundary, in the JAX codec's names and order, and `prefetch()` once a
    compress, where its device work is enqueued. Neither synchronises.

While a torch profiler records, each call also keeps spans at those
boundaries and inside them, and counters of its fused path's outcome and
its lane framing bytes (`utils/tracing.py`); otherwise nothing is kept.
"""

import collections
import copy
import struct
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import _native
from ..ans import host_coder_classes, lane_coder as lc, resolve_host_backend
from ..entropy import (
    EntropyBottleneckCoder,
    GaussianConditionalCoder,
    build_eb_tables,
    build_gc_tables,
    get_scale_table,
)
from ..layers import GDN
from ..utils import tracing
from ..utils.numerics import use_numerical_policy

_HASH_MUL = 2654435761
_HASH_ADD = 97531
_LANE_HEADER_MAGIC = 0x4C414E00
# header flag of a stream whose scale indexes a fused encode tier derived
_LANE_FLAG_FUSED_ENC = 0x01
# graphs a codec keeps of each kind (decode, encode); the least recently
# used goes first
_GRAPH_CACHE = 4
# symbols a slice above which compress takes no fused encode tier: the
# JAX codec's guard, kept because the header flag is part of the stream
_FUSED_ENC_MAX_SLICE = 2_000_000


class _LaneSideOverflow(Exception):
    """A fused-encode segment overflowed B3's escape side channel; the
    caller reruns the per-slice compress, which host-encodes it."""


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


def _z_quantize_math(z, medians):
    """z quantization, shared by the per-slice compress and the fused
    encode tiers: (int32 symbols, z_hat). z_hat = symbols + medians in
    f32, the op the decoder runs on the same values."""
    sym32 = torch.round(z.to(torch.float32) - medians).to(torch.int32)
    return sym32, sym32.to(torch.float32) + medians


def _z_tail(sym32):
    """int32 [a flag set when a z symbol leaves int8, then z's int8 NHWC
    symbols, 4 a word]: the end of a fused tier's meta vector."""
    sym8 = sym32.clamp(-128, 127).to(torch.int8)
    overflow = (sym32 != sym8.to(torch.int32)).any()
    flat = _nhwc_flat(sym8)
    pad = -flat.numel() % 4
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return torch.cat([overflow.to(torch.int32).reshape(1),
                      flat.view(torch.int32)])


def _lane_meta(banks, hashes, tail=()):
    """One int32 vector of what a lane compress reads back before it
    builds the stream: every slice's (G, 128) B3 counts, every slice's
    index hash (its u32 bits), then `tail`."""
    return torch.cat(
        [b[3].reshape(-1) for b in banks]
        + [torch.stack(hashes).to(torch.int32)] + list(tail)
    )


def _split_meta(meta: np.ndarray, S: int):
    """A fetched `_lane_meta` -> (counts (S, G, 128), u32 hashes, tail)."""
    n = S * lc.GROUPS * 128
    return (meta[:n].reshape(S, lc.GROUPS, 128),
            meta[n:n + S].view(np.uint32), meta[n + S:])


def _replayed(counted):
    """Adds one replay's counts (`Codec._capture_graph`'s): its kernel
    launches to `_native.launch_counts`, its Conv2d and B1 FLOPs to the
    open call's record."""
    launched, flops = counted
    _native.launch_counts.update(launched)
    tracing.replayed(flops)


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))


def _cat(tensors, dim: int = 0) -> torch.Tensor:
    """torch.cat, without the copy for a single tensor."""
    return tensors[0] if len(tensors) == 1 else torch.cat(tensors, dim)


def _chunked(fn, x: torch.Tensor, chunks: int):
    """fn(x) over `chunks` sequential sub-batches of x, outputs (a tensor
    or a tuple of them) concatenated along the batch; fn(x) at once when
    `chunks` does not divide the batch (the JAX codec's `chunked_apply`)."""
    if chunks <= 1 or x.shape[0] % chunks:
        return fn(x)
    outs = [fn(part) for part in x.chunk(chunks)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def _once(fn):
    """fn, called at most once however often the wrapper is: compress's
    `prefetch` across a fused tier's fallback to the per-slice walk."""
    fired = []

    def once():
        if not fired:
            fired.append(True)
            fn()

    return once


def pack12(q: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The device half of the JAX codec's packed drain (`quantize_packed`):
    v = (q + 32) << 6 | idx, 12 bits over the flat symbols, padded to an
    even count; the low bytes of all, then the high 4 bits two to a byte
    (the even symbol's in the low nibble): a uint8 buffer of 1.5 bytes a
    symbol. Exact where every q is in [-32, 31] and every idx below 64."""
    v = ((q.reshape(-1) + 32).clamp(0, 63) << 6) | idx.reshape(-1).to(torch.int32)
    if v.numel() & 1:
        v = torch.cat([v, v.new_zeros(1)])
    hi = (v >> 8).reshape(-1, 2)
    return torch.cat([(v & 0xFF).to(torch.uint8),
                      (hi[:, 0] | (hi[:, 1] << 4)).to(torch.uint8)])


def _unpack12(packed_np: np.ndarray, n: int):
    """Host inverse of `pack12`: a (1.5 * ceil2(n),) uint8 buffer ->
    (symbols int32, indexes uint8); the JAX codec's helper."""
    m = n + (n & 1)
    lo = packed_np[:m].astype(np.uint16)
    hib = packed_np[m : m + m // 2]
    hi = np.empty(m, np.uint16)
    hi[0::2] = hib & 0xF
    hi[1::2] = hib >> 4
    v = (lo | (hi << 8))[:n]
    return (v >> 6).astype(np.int32) - 32, (v & 63).astype(np.uint8)


def half_weights(model, dtype, device, bottleneck: bool = False):
    """A copy of `model` on `device` in eval mode that computes in f32 on
    weights rounded to `dtype`: what flax computes for a model whose
    parameters were cast to `dtype` and that is fed f32 activations (each
    layer promotes to the wider of the two dtypes). Every float parameter
    holds its rounded value in f32, but those a layer transforms before
    they meet an activation stay in `dtype`, so that the transform runs in
    it as flax runs it: GDN's beta and gamma (reparametrised, `GDN.forward`)
    and, with `bottleneck`, the entropy bottleneck's matrices and factors
    (softplus and tanh). Without `bottleneck` the entropy bottleneck keeps
    its f32 parameters, as the JAX codec keeps them for its CDF tables."""
    out = copy.deepcopy(model).to(device).eval()
    with torch.no_grad():
        for name, p in out.named_parameters():
            if bottleneck or not name.startswith("entropy_bottleneck."):
                p.copy_(p.to(dtype))
        kept = [(m, ("beta", "gamma")) for m in out.modules()
                if isinstance(m, GDN)]
        if bottleneck:
            eb = out.entropy_bottleneck
            kept.append((eb, [n for n, _ in eb.named_parameters()
                              if n.startswith(("_matrix", "_factor"))]))
        for m, names in kept:
            for n in names:
                p = getattr(m, n)
                p.data = p.data.to(dtype)
    return out


def _half_models(model, dtype, device):
    """(coding model, analysis model) of a codec of half `dtype`: the
    coding model is `half_weights(model, dtype, device)`, for the f32
    hyper synthesis, walk and synthesis; the analysis model is a copy of
    it that holds every parameter in `dtype`, since the analysis (g_a,
    h_a) computes in it, fed the image in `dtype`. The caller's model is
    left as it is."""
    coding = half_weights(model, dtype, device)
    return coding, copy.deepcopy(coding).to(dtype)


def resolve_device(name: str) -> torch.device:
    """The torch device a command line's `--device` names; "cuda" raises
    where there is no card (the port never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: stf_tpu_torch runs on the GPU; "
                           "pass --device cpu to run on the CPU")
    return device


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
    rANS on the CPU) or "lane" (G x 128 interleaved rANS lanes, decoded on
    the device by kernel B2). z always uses the host factorized coder.
    `device=None` means CUDA.

    The lane coder encodes each segment's y symbols where they were made,
    through kernel B3's wrapper (the kernel on CUDA, its plain version on
    CPU tensors): only stream-sized bytes cross to the host. The stream is
    byte-identical to the host lane encoder's, which re-encodes a segment
    whose escape side channel overflowed from the same symbols. (The JAX
    codec's `device_encode` switch has no counterpart: this is its
    `device_encode=True`.)

    `fused` (attribute, default True, lane only) decodes through CUDA-graph
    replays per stream geometry (see the module docstring); False always
    takes the per-slice walk. At pipeline 1 one graph holds the walk and
    the synthesis; at pipeline > 1 the walk's graph ends at the walk and a
    second graph concatenates the sub-batches' slices and synthesises (the
    JAX codec's `split_synth`). The codec keeps the graphs of the last
    `_GRAPH_CACHE` geometries, all in one memory pool.

    `fused_encode` (False, True or "split"; lane only) compresses through
    a fused encode tier: True starts at "full", "split" there (the JAX
    codec's flag). Each tier captures one CUDA graph per (tier, input
    shape, dtype), the last `_GRAPH_CACHE` kept in the same pool; the
    analysis and the hyper synthesis run at the full batch and the walk
    per sub-batch, as the decoders run them. Such a stream's indexes come
    from the captured walk, so its header carries the fused-encode flag
    and every decoder checks them against the stream's hashes. Compress
    decodes the first stream of each configuration before returning it;
    on failure it warns and demotes the tier (full -> split -> off) and
    encodes again. Past `_FUSED_ENC_MAX_SLICE` symbols in a sub-batch's
    slice, or when a segment overflows B3's side channel, compress takes
    the per-slice walk for that call, with no flag.

    `dtype`, `pipeline`, `pack_drain`, `analyze_chunks` and `synth_chunks`
    are the JAX codec's (module docstring).
    """

    def __init__(self, model, scale_table: Optional[np.ndarray] = None,
                 coder: str = "host", device=None, fused_encode=False,
                 pipeline: int = 1, dtype=None,
                 pack_drain: Optional[bool] = None, analyze_chunks: int = 1,
                 synth_chunks: int = 1):
        if coder not in ("host", "lane"):
            raise ValueError(f"unknown entropy coder {coder!r}")
        if fused_encode not in (False, True, "split"):
            raise ValueError(f"fused_encode is False, True or 'split', not "
                             f"{fused_encode!r}")
        self.dtype = torch.float32 if dtype is None else dtype
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype is torch.float32 or torch.bfloat16, not "
                             f"{dtype!r}")
        self.coder = coder
        self.fused = True
        self.fused_encode = bool(fused_encode) and coder == "lane"
        self._fused_mode = "split" if fused_encode == "split" else "full"
        self.pipeline = max(int(pipeline), 1)
        self.analyze_chunks = max(int(analyze_chunks), 1)
        self.synth_chunks = max(int(synth_chunks), 1)
        self._pack_drain_arg = pack_drain
        self.device = default_device() if device is None else torch.device(device)
        # one fixed numerical policy, so encoder and decoder agree bitwise
        use_numerical_policy()
        if self.dtype == torch.float32:
            self.model = model.to(self.device).eval()
            self._analysis_model = self.model
        else:
            self.model, self._analysis_model = _half_models(
                model, self.dtype, self.device
            )
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
        # the packed drain's 6-bit idx field holds at most 64 levels
        levels = len(self.scale_table)
        self._pack_drain = (levels <= 64 if self._pack_drain_arg is None
                            else bool(self._pack_drain_arg))
        if self._pack_drain and levels > 64:
            raise ValueError(
                "pack_drain=True requires a scale table of <= 64 levels "
                f"(idx must fit 6 bits; got {levels}): a wider table would "
                "bleed idx bits into the q field and corrupt host-coder "
                "streams"
            )
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
            # captured graphs close over the tables: drop them, and
            # verify the first stream of every new encode graph again
            self._graphs = collections.OrderedDict()
            self._enc_graphs = collections.OrderedDict()
            self._enc_verified = set()
            self._graph_pool = None
        return True

    # -- shared pieces --------------------------------------------------------

    def _sub_batches(self, B: int):
        """[(lo, hi)] of the `pipeline` sub-batches of a batch of B; one
        when `pipeline` does not divide B (the JAX codec's rule)."""
        K = self.pipeline
        if K > B or B % K:
            K = 1
        step = B // K
        return [(k * step, (k + 1) * step) for k in range(K)]

    def _z_dequantize(self, z_sym: torch.Tensor) -> torch.Tensor:
        """z_hat = symbols + medians in f32: the same op on both sides."""
        return z_sym.to(torch.float32) + self._medians

    def _walk_slices(self, latent_means, latent_scales, get_symbols,
                     pin=lambda t: t, need_y_hat=True):
        """The channel-AR slice chain of one sub-batch. `get_symbols(i, mu,
        idx)` returns the int32 NCHW symbols of slice i, from quantization
        (encoder) or from the stream (decoder). Both sides run exactly this
        walk, at the sub-batch's shapes; `need_y_hat=False` (the encoder)
        skips the last slice's apply, which feeds nothing the encoder
        reads. The fused decompress passes `pin=lc.layout_pin`, which
        copies every operand at the positions where the JAX codec's fused
        walk (`_traced_walk`) pins them; the copies change no value. On CUDA
        the pins of rv (an NHWC tensor viewed as NCHW) give it packed NCHW
        strides (kernel B4's transpose path); lm/ls (a sub-batch of crops
        of the hyper outputs that keep every element, since y_shape is 4 x
        z), mu and y_prev come packed, and their pins only keep JAX's
        positions."""
        model, table = self.model, self._table
        k = model.max_support_slices
        y_hat_slices: List = []

        def support():
            return tuple(y_hat_slices if k < 0 else y_hat_slices[:k])

        lm, ls = pin(latent_means), pin(latent_scales)
        mu, idx = model.decode_slice_indexes(0, lm, ls, (), table)
        mu = pin(mu)
        for i in range(1, model.num_slices):
            rv = pin(get_symbols(i - 1, mu, idx))
            y_prev, mu, idx = model.decode_slice_fused(
                i, lm, ls, support(), mu, rv, table
            )
            mu = pin(mu)
            y_hat_slices.append(pin(y_prev))
        rv = pin(get_symbols(model.num_slices - 1, mu, idx))
        if need_y_hat:
            y_hat_slices.append(model.decode_slice_apply(
                model.num_slices - 1, lm, support(), mu, rv
            ))
        return y_hat_slices

    @staticmethod
    def _normalize(x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 or float image -> NCHW f32, where it lies."""
        x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.float()
        return x.permute(0, 3, 1, 2).contiguous()

    def _analyze(self, x: torch.Tensor):
        """NCHW f32 image -> (y, z) at the codec's dtype, the analysis run
        in `analyze_chunks` sub-batches."""
        return _chunked(self._analysis_model.analyze, x.to(self.dtype),
                        self.analyze_chunks)

    def _synthesize(self, y_hats) -> torch.Tensor:
        """Per-sub-batch lists of y_hat slices -> the NHWC x_hat of the
        batch, the synthesis run in `synth_chunks` sub-batches."""
        y_hat = _cat([_cat(h, 1) for h in y_hats])
        x_hat = _chunked(self.model.synthesize, y_hat, self.synth_chunks)
        return x_hat.permute(0, 2, 3, 1).contiguous()

    def _encode_walk(self, y, latent_means, latent_scales):
        """The encoder's walk on NCHW y of one sub-batch: per-slice NHWC
        int32 symbols and indexes, and for the lane coder each slice's B3
        outputs (words, side, states, counts) and index hash (an int64
        device scalar). Reads nothing back to the host, so the fused tiers
        capture it."""
        lane = self.coder == "lane"
        pad_sym = int(self.lane_tables.offsets[0]) if lane else 0
        y_slices = self.model.split_slices(y)
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        symbols, indexes, banks, hashes = [], [], [], []

        def get_symbols(i, mu, idx):
            # a bf16 y meets the f32 mu in f32, as in the JAX walk
            q = torch.round(y_slices[i] - mu).to(torch.int32)
            symbols.append(nhwc(q))
            indexes.append(nhwc(idx))
            if lane:
                idx_flat = _nhwc_flat(idx)
                banks.append(lc.lane_encode_device(
                    _nhwc_flat(q), idx_flat, *self._lane_dev_tables,
                    q.numel(), pad_sym,
                ))
                hashes.append(idx_hash(idx_flat))
            return q

        self._walk_slices(latent_means, latent_scales, get_symbols,
                          need_y_hat=False)
        return symbols, indexes, banks, hashes

    def _segment_walks(self, y, latent_means, latent_scales):
        """`_encode_walk` of every sub-batch of y, its four lists in
        segment order: segment i * P + k is slice i of sub-batch k."""
        walks = [self._encode_walk(y[lo:hi], latent_means[lo:hi],
                                   latent_scales[lo:hi])
                 for lo, hi in self._sub_batches(y.shape[0])]
        return tuple([w[f][i] for i in range(len(walks[0][f])) for w in walks]
                     for f in range(4))

    def _per_slice(self, segments):
        """Per-segment NHWC tensors (slice-major) -> one tensor a slice,
        its sub-batches concatenated along the batch."""
        P = len(segments) // self.model.num_slices
        return [_cat(segments[i:i + P]) for i in range(0, len(segments), P)]

    # -- compress ------------------------------------------------------------

    @tracing.traced("encode", "upload")
    @torch.inference_mode()
    def compress(self, x, probe=None, prefetch=None) -> Dict[str, Any]:
        """x: (B, H, W, 3) uint8 or float in [0, 1]. Returns the strings,
        the z spatial shape, and the per-slice NHWC int32 symbols and
        indexes that were coded (device tensors). Lane codecs also return
        "host_encoded", the number of y segments whose side channel
        overflowed in B3 and that the host encoder coded instead. With
        `fused_encode` set this tries the fused tier first.

        `probe(name, tensor or None)` is called at each phase boundary,
        with the JAX codec's names in its order (upload, analyze, hyper,
        walk, then entropy for the lane coder or drain and rans for the
        host coder, then z_rans; a fused tier: upload, fused_encode_walk,
        entropy, z_rans, and fused_verify after its first stream's
        self-check; fused_encode_fallback before a per-slice rerun). The
        codec never waits for the tensor it passes: a probe that does
        serialises the call, so time with one only to attribute.
        `prefetch()` is called exactly once, where this call's device work
        is enqueued and the host is about to wait for it (a caller starts
        the next batch's upload there)."""
        if prefetch is not None:
            prefetch = _once(prefetch)
        if self.fused_encode:
            out = self._compress_fused(x, probe, prefetch)
            if out is not None:
                return out
            tracing.boundary(probe, "fused_encode_fallback", None, "upload")
        model = self.model
        x_dev = _as_tensor(x).to(self.device)
        tracing.boundary(probe, "upload", x_dev, "analyze")
        y, z = self._analyze(self._normalize(x_dev))
        tracing.boundary(probe, "analyze", y, "hyper")
        if self.fused_encode:
            self._check_latent(x.shape, y)
        z_sym, z_hat = _z_quantize_math(z, self._medians)
        latent_means, latent_scales = model.hyper_synthesize(
            z_hat, (y.shape[2], y.shape[3])
        )
        tracing.boundary(probe, "hyper", latent_scales, "walk")
        symbols, indexes, banks, hashes = self._segment_walks(
            y, latent_means, latent_scales
        )
        if prefetch is not None:
            prefetch()
        lane = self.coder == "lane"
        tracing.boundary(probe, "walk", symbols[-1],
                         "entropy" if lane else "drain")
        out = {
            "shape": (z.shape[2], z.shape[3]),
            "symbols": self._per_slice(symbols),
            "indexes": self._per_slice(indexes),
        }
        if lane:
            with tracing.span("meta_fetch", "wait"):
                meta = _lane_meta(banks, hashes).cpu().numpy()
            counts, hvec, _ = _split_meta(meta, len(banks))
            blob, out["host_encoded"] = self._build_lane_stream(
                counts, hvec, banks, symbols, indexes
            )
            y_strings = [blob]
            tracing.boundary(probe, "entropy", None, "z_rans")
        else:
            drained = self._drain(symbols, indexes)
            tracing.boundary(probe, "drain", None, "rans")
            # per-image streams, slices 0..S-1 (the JAX host layout, the
            # same bytes at any pipeline)
            cdf, lengths, offsets = self.gc_coder.tables.astuple()
            encoders = [
                host_coder_classes(self.host_backend)[0]()
                for _ in range(y.shape[0])
            ]
            subs = self._sub_batches(y.shape[0])
            for j, (s, i) in enumerate(drained):
                lo, hi = subs[j % len(subs)]
                s, i = s.reshape(hi - lo, -1), i.reshape(hi - lo, -1)
                for b in range(hi - lo):
                    encoders[lo + b].encode_with_indexes(
                        s[b], i[b], cdf, lengths, offsets,
                    )
            y_strings = [e.flush() for e in encoders]
            tracing.boundary(probe, "rans", None, "z_rans")

        with tracing.span("z_fetch", "wait"):
            z_np = z_sym.permute(0, 2, 3, 1).cpu().numpy()
        with tracing.span("z_code", "host"):
            z_strings = self.eb_coder.compress_symbols(z_np)
        tracing.boundary(probe, "z_rans")
        out["strings"] = [y_strings, z_strings]
        return out

    def _drain(self, symbols, indexes):
        """The host coder's (symbols, indexes) NumPy pair of each segment
        (NHWC device tensors), in two fetches: every segment's least and
        largest symbol, then one byte buffer of every segment's drain, as
        the JAX codec's drain chooses it: 12 bits a symbol (`pack12`) when
        the packed drain is on and the segment's symbols lie in [-32, 31];
        else int8 symbols (int32 when one leaves int8) and a byte an index
        (int32 past 255 table levels). The integers are the same either
        way, and so are the streams."""
        ranges = torch.stack(
            [torch.stack([q.min(), q.max()]) for q in symbols]
        ).cpu().numpy()
        wide_idx = len(self.scale_table) > 255
        parts, kinds = [], []
        for (least, most), q, idx in zip(ranges, symbols, indexes):
            if self._pack_drain and least >= -32 and most <= 31:
                kinds.append("packed")
                parts.append(pack12(q, idx))
                continue
            narrow = least >= -128 and most <= 127
            kinds.append("int8" if narrow else "int32")
            parts += [q.to(torch.int8) if narrow else q,
                      idx if wide_idx else idx.to(torch.uint8)]
        flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts])
        flat = flat.cpu().numpy()
        out, at = [], 0

        def take(nbytes, dtype):
            nonlocal at
            at += nbytes
            return flat[at - nbytes:at].view(dtype)

        for kind, q in zip(kinds, symbols):
            n = q.numel()
            if kind == "packed":
                out.append(_unpack12(take(3 * ((n + 1) // 2), np.uint8), n))
                continue
            sym = take(n, np.int8) if kind == "int8" else take(4 * n, np.int32)
            idx = take(4 * n, np.int32) if wide_idx else take(n, np.uint8)
            out.append((sym, idx))
        return out

    def _build_lane_stream(self, counts, hashes, banks, symbols, indexes,
                           flags: int = 0):
        """The lane y-stream with header `flags`, and how many segments
        the host encoder coded, from every segment's B3 counts (n, G, 128)
        and index hash (fetched), B3 banks (words, side, states) and NHWC
        symbols and indexes (device tensors), in segment order.

        Segments B3 encoded without overflow come over as bucketed tails,
        one fetch per segment geometry, so only ~stream bytes cross; a
        segment whose side channel overflowed is encoded by the native
        host encoder from the same symbols. The two encoders are
        bit-exact, so the mix is invisible to decoders. A fused-encode
        stream (flag set) takes no host segment: it raises
        `_LaneSideOverflow` instead, as the JAX codec does."""
        G, K = lc.GROUPS, lc.K
        S = len(banks)
        if flags & _LANE_FLAG_FUSED_ENC and counts[:, :, 2].any():
            raise _LaneSideOverflow(np.flatnonzero(counts[:, :, 2].any(1)))

        def numel(j):
            return symbols[j].numel()

        def tail_rows(js, col, cap):  # the rows that hold every js stream
            most = max(int(counts[j][:, col].max()) for j in js)
            return min(_bucket(-(-most // K) + 1), cap)

        geometries: Dict = collections.defaultdict(list)
        for j in range(S):
            if not counts[j][:, 2].any():
                geometries[lc.encode_caps(numel(j))].append(j)
        segments: Dict = {}
        for (tg, wcap_rows, scap_rows), js in geometries.items():
            wb, sb = tail_rows(js, 0, tg), tail_rows(js, 1, scap_rows)
            with tracing.span("tails_fetch", "wait"):
                parts = [
                    torch.stack([
                        banks[j][0].reshape(G, wcap_rows, K)[:, tg - wb:tg]
                        for j in js
                    ]),
                    torch.stack([
                        banks[j][1].reshape(G, scap_rows, K)[:, :sb]
                        for j in js
                    ]),
                    torch.stack([banks[j][2] for j in js]),
                ]
                flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
            with tracing.span("assemble", "host"):
                w, s, st = (
                    a.reshape(p.shape) for a, p in zip(
                        np.split(flat,
                                 np.cumsum([p.numel() for p in parts[:2]])),
                        parts,
                    )
                )
                for m, j in enumerate(js):
                    segments[j] = lc.assemble_from_tails(
                        w[m], s[m], st[m], counts[j], numel(j)
                    )

        host = [j for j in range(S) if j not in segments]
        if host:
            with tracing.span("host_lane_encode", "host"):
                for j in host:
                    segments[j] = lc.lane_encode(
                        symbols[j].cpu().numpy().reshape(-1),
                        indexes[j].cpu().numpy().reshape(-1),
                        self.lane_tables,
                    )
        with tracing.span("pack", "host"):
            ordered = [segments[j] for j in range(S)]
            blob = (
                np.asarray([_LANE_HEADER_MAGIC | flags], "<u4").tobytes()
                + hashes.astype("<u4").tobytes()
                + lc.pack_lane_stream(ordered)
            )
        call = tracing.current()
        if call is not None:
            # the header word and the index hashes, then the lane format's
            # own framing
            call.framing_bytes = 4 + 4 * S + lc.framing_bytes(ordered)
        return blob, len(host)

    # -- fused encode tiers ---------------------------------------------------

    def _latent_hw(self, x_shape):
        """y's (height, width) for a (B, H, W, 3) input, from its shape:
        the analysis's `analysis_downsample` rounded up."""
        d = self.model.analysis_downsample
        return -(-x_shape[1] // d), -(-x_shape[2] // d)

    def _check_latent(self, x_shape, y):
        """Holds the analysis's real y against `_latent_hw`, on which the
        size guard (and so the header flag) decides; a codec with a fused
        tier checks every compress."""
        if tuple(y.shape[2:]) != self._latent_hw(x_shape):
            raise RuntimeError(
                f"analysis gave y of {tuple(y.shape[2:])} for a "
                f"{tuple(x_shape[1:3])} input, not {self._latent_hw(x_shape)}: "
                "the model's analysis_downsample is wrong"
            )

    def _fused_fits(self, x_shape) -> bool:
        """Whether a (B, H, W, 3) input's largest slice of a sub-batch
        holds at most `_FUSED_ENC_MAX_SLICE` symbols, from its shape
        alone."""
        model, M = self.model, self.model.M
        yh, yw = self._latent_hw(x_shape)
        widths = np.diff([0] + model.slice_boundaries(M) + [M])
        step = max(hi - lo for lo, hi in self._sub_batches(x_shape[0]))
        return step * yh * yw * int(widths.max()) <= _FUSED_ENC_MAX_SLICE

    def _fused_encode_walk(self, mode, inputs):
        """The encode a fused tier captures into one CUDA graph: "full"
        takes (x,), the NHWC input image, and runs normalisation, analysis,
        z quantization and hyper synthesis at the full batch, then the
        walk of every sub-batch; "split" takes (y, lm, ls, z tail) made
        eagerly and runs the walks. Both run the per-slice compress's
        walks, unpinned: every operand there is packed already, so a pin
        would change no value and no stride. Reads nothing back to the
        host. Returns (meta, per-segment B3 banks (words, side, states),
        per-segment NHWC symbols, indexes, and z's int32 symbols, or None
        in "split"); meta is `_lane_meta` with the `_z_tail`."""
        if mode == "full":
            (x,) = inputs
            y, z = self._analyze(self._normalize(x))
            self._check_latent(x.shape, y)
            z_sym, z_hat = _z_quantize_math(z, self._medians)
            lm, ls = self.model.hyper_synthesize(z_hat, (y.shape[2], y.shape[3]))
            z_tail = _z_tail(z_sym)
        else:
            y, lm, ls, z_tail = inputs
            z_sym = None
        symbols, indexes, banks, hashes = self._segment_walks(y, lm, ls)
        return (_lane_meta(banks, hashes, [z_tail]), [b[:3] for b in banks],
                symbols, indexes, z_sym)

    def _capture_encode(self, mode, inputs):
        """(graph, static inputs, pinned staging buffers, static outputs,
        counts per replay) of `mode`'s encode. Each static input
        has its eager tensor's shape, dtype and strides, so the captured
        walk computes on the layouts the per-slice compress computes on.
        An input on the host (the full tier's image) gets a pinned buffer
        of its own that it is staged through at every replay."""
        statics = [
            torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                device=self.device).copy_(t)
            for t in inputs
        ]
        staging = [
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if t.device.type == "cpu" else None
            for t in inputs
        ]
        graphs, out, counted = self._capture_graph(
            lambda: self._fused_encode_walk(mode, statics)
        )
        return graphs, statics, staging, out, counted

    def _compress_fused(self, x, probe=None,
                        prefetch=None) -> Optional[Dict[str, Any]]:
        """The lane compress through the fused tier `self._fused_mode`:
        one graph replay (eager on CPU tensors, through the kernels' plain
        versions), one fetch of the meta vector, the stream built with the
        fused-encode flag. None when the input is past the size guard, a
        segment overflowed B3's side channel, or the split tier's
        self-check failed: the caller then runs the per-slice compress.
        A capture or launch failure raises."""
        if not self._fused_fits(x.shape):
            tracing.outcome("size_guard")
            return None
        model, mode = self.model, self._fused_mode
        x = _as_tensor(x)
        if mode == "full":
            x_dev, inputs = x, (x,)
        else:  # analysis, z and hyper as the per-slice compress runs them
            x_dev = x.to(self.device)
            y, z = self._analyze(self._normalize(x_dev))
            self._check_latent(x.shape, y)
            z_sym, z_hat = _z_quantize_math(z, self._medians)
            lm, ls = model.hyper_synthesize(z_hat, (y.shape[2], y.shape[3]))
            inputs = (y, lm, ls, _z_tail(z_sym))
        key = (mode, tuple(x.shape), x.dtype)
        if self.device.type == "cpu":
            tracing.outcome("eager")
            meta, banks, symbols, indexes, z_out = self._fused_encode_walk(
                mode, inputs
            )
        else:
            graphs, statics, staging, out, counted = self._cached_graph(
                self._enc_graphs, key,
                lambda: self._capture_encode(mode, inputs),
            )
            # a staging buffer is free again: every call waits for its
            # replay (the meta fetch) before it returns
            for static, pinned, t in zip(statics, staging, inputs):
                static.copy_(t if pinned is None else pinned.copy_(t),
                             non_blocking=True)
            if mode == "full":
                x_dev = statics[0]
            with tracing.span("replay", "launch"):
                for graph in graphs:
                    graph.replay()
            _replayed(counted)
            meta, banks, symbols, indexes, z_out = out
            # the next replay overwrites the graph's outputs
            symbols = [s.clone() for s in symbols]
            indexes = [i.clone() for i in indexes]
        if prefetch is not None:
            prefetch()
        tracing.boundary(probe, "upload", x_dev, "fused_encode_walk")
        if mode == "full":
            z_sym = z_out
        with tracing.span("meta_fetch", "wait"):
            meta = meta.cpu().numpy()
        counts, hashes, z_tail = _split_meta(meta, len(banks))
        tracing.boundary(probe, "fused_encode_walk", None, "entropy")
        try:
            blob, _ = self._build_lane_stream(
                counts, hashes, banks, symbols, indexes,
                flags=_LANE_FLAG_FUSED_ENC,
            )
        except _LaneSideOverflow:
            tracing.outcome("side_overflow")
            return None
        tracing.boundary(probe, "entropy", None, "z_rans")
        B, _, zh, zw = z_sym.shape
        if z_tail[0]:  # a z symbol left int8: fetch the int32 copy
            with tracing.span("z_fetch", "wait"):
                z_np = z_sym.permute(0, 2, 3, 1).cpu().numpy()
        else:
            z_np = z_tail[1:].view(np.int8)[:z_sym.numel()].reshape(B, zh, zw, -1)
        with tracing.span("z_code", "host"):
            z_strings = self.eb_coder.compress_symbols(z_np)
        out = {
            "strings": [[blob], z_strings],
            "shape": (zh, zw),
            "symbols": self._per_slice(symbols),
            "indexes": self._per_slice(indexes),
            "host_encoded": 0,
        }
        verify = key not in self._enc_verified
        tracing.boundary(probe, "z_rans", None,
                         "fused_verify" if verify else "tail")
        if verify:
            # the first stream of a configuration must decode before it
            # leaves: its indexes come from a graph no decoder replays
            try:
                with tracing.span("self_check", "stage"):
                    self.decompress(out["strings"], out["shape"])
            except (ValueError, IndexError, KeyError, struct.error):
                tracing.outcome("demoted")
                if mode == "full":
                    warnings.warn(
                        "fused encode self-check FAILED: no decoder derives "
                        "the full tier's scale indexes for this "
                        "configuration; demoting to the split tier and "
                        "encoding again", RuntimeWarning,
                    )
                    self._fused_mode = "split"
                    return self._compress_fused(x, probe, prefetch)
                warnings.warn(
                    "fused encode self-check FAILED: no decoder derives the "
                    "split tier's scale indexes for this configuration; "
                    "disabling the fused encode and encoding again with "
                    "the per-slice walk", RuntimeWarning,
                )
                self.fused_encode = False
                return None
            self._enc_verified.add(key)
            tracing.boundary(probe, "fused_verify")
        return out

    def _cached_graph(self, graphs, key, capture):
        """graphs[key], captured by `capture()` if absent, kept as the
        most recently used; the least recently used past `_GRAPH_CACHE`
        goes."""
        entry = graphs.pop(key, None)
        tracing.outcome("replay" if entry is not None else "capture")
        if entry is None:
            entry = capture()
        graphs[key] = entry
        if len(graphs) > _GRAPH_CACHE:
            graphs.popitem(last=False)
        return entry

    def _capture_graph(self, fn, *more):
        """Run `fn` once eagerly (loads every kernel, fills cuDNN's
        handles and the layers' caches), then capture it: ([graph], its
        static outputs, counts per replay: (kernel launches, Conv2d FLOPs
        by route and B1 FLOPs by design)). Each of `more`, a function of
        the outputs before it, is then run and captured the same way into
        a graph of its own, replayed after the ones before; the outputs
        returned are the last function's. The counts are Python-side, so
        they move at capture only: the capture's launch increments are
        taken back, its FLOPs kept aside (`tracing.capturing`), and the
        caller adds both at every replay (`_replayed`).

        Every graph allocates in the codec's one memory pool. Graphs run
        one at a time on one stream, and a replay's outputs are read or
        cloned out before the next replay of that graph, so a graph may
        reuse what another's intermediates held; each graph's own outputs
        stay allocated."""
        counts = _native.launch_counts
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graphs, launched, out = [], collections.Counter(), None
        flops = tracing.FlopSums()
        for step in (fn,) + more:
            run = step if out is None else (lambda s=step, o=out: s(o))
            run()
            torch.cuda.synchronize(self.device)
            before = collections.Counter(counts)
            graph = torch.cuda.CUDAGraph()
            with tracing.capturing(flops), torch.cuda.graph(
                    graph, pool=self._graph_pool):
                out = run()
            step_launched = counts - before
            counts.subtract(step_launched)
            launched += step_launched
            graphs.append(graph)
        return graphs, out, (launched, flops)

    # -- decompress ----------------------------------------------------------

    def _lane_segments(self, blob: bytes, n: int):
        """Parse a lane y-stream of `n` segments (num_slices x pipeline):
        (header flags, encoder index hashes, segments)."""
        if len(blob) < 4 + 4 * n:
            raise ValueError(
                f"lane y-stream is {len(blob)} bytes — shorter than its "
                f"{4 + 4 * n}-byte header (truncated, or not a lane stream)"
            )
        header = int(np.frombuffer(blob[:4], "<u4")[0])
        if (header & 0xFFFFFF00) != _LANE_HEADER_MAGIC:
            raise ValueError(
                f"lane y-stream header 0x{header:08x} does not carry magic "
                f"0x{_LANE_HEADER_MAGIC:08x}"
            )
        hashes = np.frombuffer(blob[4 : 4 + 4 * n], "<u4").astype(np.int64)
        segments = lc.unpack_lane_stream(blob[4 + 4 * n :])
        if len(segments) != n:
            raise ValueError(
                f"lane stream has {len(segments)} segments, expected {n}: "
                "num_slices x pipeline of this codec and batch"
            )
        return header & 0xFF, hashes, segments

    def _upload_segment(self, seg):
        wr = _bucket(lc.words_rows_for(seg.word_counts.max()))
        sr = _bucket(lc.side_rows_for(seg.side_counts.max()))
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return (
            put(lc.pack_word_banks(seg, wr)),
            put(lc.pad_side_banks(seg, sr)),
            lc.states_tensor(seg, self.device),
        )

    def _lane_symbols(self, banks, ns, hashes, decoded, packed=True):
        """get_symbols for a lane decode walk: slice i's symbols by kernel
        B2 from banks[i] (words, side, states), its index hash appended to
        `hashes` and its NHWC symbols to `decoded`. The symbols come back
        as packed NCHW (as compress's q), or, with packed=False, as an
        NCHW view of the NHWC tensor for a walk whose pin packs it."""
        def get_symbols(i, mu, idx):
            _, c, h, w = idx.shape
            idx_flat = _nhwc_flat(idx)
            n = idx_flat.numel()
            if ns[i] != n:
                raise ValueError(
                    "lane segment symbol count does not match the slice shape"
                )
            hashes.append(idx_hash(idx_flat))
            rv = lc.lane_decode(
                idx_flat, *banks[i], *self._lane_dev_tables, n
            ).reshape(-1, h, w, c)
            decoded.append(rv)
            rv = rv.permute(0, 3, 1, 2)
            return rv.contiguous() if packed else rv

        return get_symbols

    def _lane_walks(self, latent_means, latent_scales, subs, banks, ns,
                    pin=lambda t: t, packed=True):
        """The decode walk of every sub-batch on lane segments (slice-major
        `banks` and symbol counts `ns`): (per-sub-batch y_hat slices,
        per-segment index hashes, per-slice NHWC symbols)."""
        P = len(subs)
        y_hats, hashes, decoded = [], [], []
        for k, (lo, hi) in enumerate(subs):
            h_k, d_k = [], []
            y_hats.append(self._walk_slices(
                latent_means[lo:hi], latent_scales[lo:hi],
                self._lane_symbols(banks[k::P], ns[k::P], h_k, d_k, packed),
                pin=pin,
            ))
            hashes.append(h_k)
            decoded.append(d_k)
        S = self.model.num_slices
        return (y_hats, [hashes[k][i] for i in range(S) for k in range(P)],
                [_cat([d[i] for d in decoded]) for i in range(S)])

    def _fused_walk(self, key, buf):
        """The fused decompress's walk on one flat int32 buffer (offset
        table, z latent, `flat_banks` payload): z_hat (pinned) -> hyper
        synthesis at the full batch -> the pinned walk of each sub-batch
        with B2 per segment. Returns (per-sub-batch y_hat slices, stacked
        per-segment index hashes, per-slice NHWC symbols). Reads no value
        back to the host, so it can be captured into a CUDA graph; the
        bank offsets are read on the device."""
        y_shape, wr, sr, ns, z_shape, z_is_sym, subs, _ = key
        model, dev = self.model, buf.device
        G, K, n_seg = lc.GROUPS, lc.K, len(ns)
        n_boffs = n_seg * 3 * G
        zn = int(np.prod(z_shape))
        z_words = (zn + 3) // 4 if z_is_sym else zn
        boffs = buf[:n_boffs].reshape(n_seg, 3, G, 1).to(torch.int64)
        zw = buf[n_boffs:n_boffs + z_words]
        if z_is_sym:
            z = zw.view(torch.int8)[:zn].reshape(z_shape).to(torch.float32)
            z = z + self._medians.reshape(-1)
        else:
            z = zw.view(torch.float32).reshape(z_shape)
        z_hat = lc.layout_pin(z.permute(0, 3, 1, 2))

        def window(which, rows):  # (n_seg, G*rows, K): G windows a segment
            at = boffs[:, which] + torch.arange(rows * K, device=dev)
            return buf[at].reshape(n_seg, G * rows, K)

        banks = list(zip(window(0, wr), window(1, sr), window(2, 1)))
        latent_means, latent_scales = model.hyper_synthesize(z_hat, y_shape)
        y_hats, hashes, decoded = self._lane_walks(
            latent_means, latent_scales, subs, banks, ns, pin=lc.layout_pin,
            packed=False,
        )
        return y_hats, torch.stack(hashes), decoded

    def _fused_decompress(self, z_sym, y_shape, subs, segments, enc_hashes,
                          probe=None):
        """One-upload lane decompress, replaying the walk's graph and (at
        pipeline 1 in the same graph) the synthesis's; None when its index
        hashes differ from the stream's (the caller then takes the
        per-slice walk). The first stream of a geometry runs the walk once
        eagerly (loads every kernel, fills cuDNN's handles and the layers'
        caches) and captures it; every call replays on a buffer sized for
        the geometry. On CPU tensors it runs eagerly through the kernels'
        plain versions."""
        with tracing.span("banks_pack", "host"):
            wr = _bucket(max(
                lc.words_rows_for(s.word_counts.max()) for s in segments
            ))
            sr = _bucket(max(
                lc.side_rows_for(s.side_counts.max()) for s in segments
            ))
            flat, boffs = lc.flat_banks(segments, wr, sr)
            z_is_sym = bool(z_sym.min() >= -128 and z_sym.max() <= 127)
            if z_is_sym:
                zb = np.zeros((z_sym.size + 3) // 4 * 4, np.int8)
                zb[: z_sym.size] = z_sym.reshape(-1)
                z_i32 = zb.view("<i4")
            else:
                z_i32 = (z_sym.astype(np.float32) + self.eb_coder.medians)
                z_i32 = z_i32.reshape(-1).view(np.int32)
            hdr = boffs.size + z_i32.size
            buf = np.concatenate([
                (boffs.reshape(-1) + hdr).astype(np.int32), z_i32, flat
            ])
        tracing.boundary(probe, "banks_pack", None, "banks_upload")
        key = (
            y_shape, wr, sr, tuple(s.n for s in segments), z_sym.shape,
            z_is_sym, tuple(subs), self.synth_chunks,
        )

        if self.device.type == "cpu":
            tracing.outcome("eager")
            buf_dev = torch.from_numpy(buf)
            tracing.boundary(probe, "banks_upload", buf_dev, "fused_walk_synth")
            y_hats, hvec, symbols = self._fused_walk(key, buf_dev)
            x_hat = self._synthesize(y_hats)
        else:
            graphs, static_buf, out, counted = self._cached_graph(
                self._graphs, key, lambda: self._capture(key, buf)
            )
            with tracing.span("upload", "host"):
                staged = torch.from_numpy(buf).pin_memory()
                static_buf[: buf.size].copy_(staged, non_blocking=True)
            tracing.boundary(probe, "banks_upload", static_buf,
                             "fused_walk_synth")
            with tracing.span("replay", "launch"):
                for graph in graphs:
                    graph.replay()
            _replayed(counted)
            # the next replay overwrites the graph's outputs
            x_hat, hvec = out[0].clone(), out[1].clone()
            symbols = [s.clone() for s in out[2]]
        with tracing.span("hash_fetch", "wait"):
            got = hvec.cpu().numpy()
        if np.array_equal(got, enc_hashes):
            tracing.boundary(probe, "fused_walk_synth", x_hat)
            return {"x_hat": x_hat, "symbols": symbols}
        tracing.outcome("hash_fallback")
        P = len(subs)
        bad = [(int(j) // P, int(j) % P)
               for j in np.flatnonzero(got != enc_hashes)]
        warnings.warn(
            "fused lane decode derived different scale indexes than the "
            f"encoder at (slice, sub-batch) {bad}; falling back to the "
            "per-slice walk", RuntimeWarning,
        )
        return None

    def _capture(self, key, buf):
        """(graphs, static input buffer, static outputs (x_hat, hashes,
        symbols), counts per replay) of the fused decompress for
        `key`: one graph of the walk and the synthesis at pipeline 1; at
        pipeline > 1 the walk's graph ends at the walk and a second graph
        synthesises from its outputs, as the JAX codec's split_synth."""
        y_shape, wr, sr, ns, z_shape, z_is_sym, subs, _ = key
        G, K = lc.GROUPS, lc.K
        zn = int(np.prod(z_shape))
        # the largest buffer of this geometry: per group at most wr*K word
        # pairs, sr*K side values and K states, then the zero tail
        capacity = (
            len(ns) * 3 * G + ((zn + 3) // 4 if z_is_sym else zn)
            + len(ns) * G * (wr + sr + 1) * K + max(wr, sr) * K
        )
        static_buf = torch.zeros(
            capacity, dtype=torch.int32, device=self.device
        )
        static_buf[: buf.size].copy_(torch.from_numpy(buf))

        def walk():
            return self._fused_walk(key, static_buf)

        def synth(walked):
            y_hats, hvec, symbols = walked
            return self._synthesize(y_hats), hvec, symbols

        if len(subs) == 1:
            graphs, out, counted = self._capture_graph(lambda: synth(walk()))
        else:
            graphs, out, counted = self._capture_graph(walk, synth)
        return graphs, static_buf, out, counted

    @tracing.traced("decode", "z_host_rans")
    @torch.inference_mode()
    def decompress(self, strings: Sequence, shape, probe=None) -> Dict[str, Any]:
        """Returns the NHWC x_hat in [0, 1] and the per-slice NHWC int32
        symbols decoded (device tensors). `probe(name, tensor or None)` as
        in `compress`, with the JAX codec's decode names in its order:
        z_host_rans, then for the lane coder y_unpack and, fused,
        banks_pack, banks_upload and fused_walk_synth; z_decode before a
        per-slice walk."""
        model = self.model
        y_strings, z_strings = strings[0], strings[1]
        with tracing.span("z_code", "host"):
            z_sym = self.eb_coder.decompress_symbols(z_strings, shape)
        lane = self.coder == "lane"
        tracing.boundary(probe, "z_host_rans", None,
                         "y_unpack" if lane else "z_decode")
        B = z_sym.shape[0]
        S = model.num_slices
        subs = self._sub_batches(B)
        up = model.hyper_upsample
        y_shape = (shape[0] * up, shape[1] * up)

        if lane:
            with tracing.span("unpack", "host"):
                flags, enc_hashes, segments = self._lane_segments(
                    y_strings[0] if len(y_strings) else b"", S * len(subs)
                )
            tracing.boundary(probe, "y_unpack", None,
                             "banks_pack" if self.fused else "z_decode")
            if self.fused:
                out = self._fused_decompress(
                    z_sym, y_shape, subs, segments, enc_hashes, probe
                )
                if out is not None:
                    return out
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
        # canonical NCHW strides, as compress's z_hat has: a (B, C, 1, 1)
        # permuted view counts as contiguous yet carries channels-last
        # strides, which change the convolution's summation order
        z_hat = self._z_dequantize(z_dev).clone(
            memory_format=torch.contiguous_format
        )
        tracing.boundary(probe, "z_decode", z_hat)
        latent_means, latent_scales = model.hyper_synthesize(z_hat, y_shape)
        if lane:
            y_hats, dec_hashes, decoded = self._lane_walks(
                latent_means, latent_scales, subs, banks,
                [seg.n for seg in segments],
            )
            with tracing.span("hash_fetch", "wait"):
                got = torch.stack(dec_hashes).cpu().numpy()
            if not np.array_equal(got, enc_hashes):
                if flags & _LANE_FLAG_FUSED_ENC and not self.fused:
                    # a fused encode tier derived this stream's indexes;
                    # the fused walk, not tried yet, may derive them too
                    out = self._fused_decompress(
                        z_sym, y_shape, subs, segments, enc_hashes, probe
                    )
                    if out is not None:
                        return out
                P = len(subs)
                bad = [(int(j) // P, int(j) % P)
                       for j in np.flatnonzero(got != enc_hashes)]
                raise ValueError(
                    "lane decode derived different scale indexes than the "
                    f"encoder (index hash mismatch at (slice, sub-batch) "
                    f"{bad}); the decoded image is not valid"
                )
        else:
            y_hats, per_sub = [], []
            for lo, hi in subs:
                decoded_k = []

                def get_symbols(i, mu, idx, lo=lo, hi=hi, out=decoded_k):
                    _, c, h, w = idx.shape
                    idx_np = _nhwc_flat(idx).cpu().numpy().reshape(hi - lo, -1)
                    rv = torch.from_numpy(np.stack([
                        decoders[lo + b].decode_stream(
                            idx_np[b], cdf, lengths, offsets
                        ) for b in range(hi - lo)
                    ])).to(self.device).reshape(hi - lo, h, w, c)
                    out.append(rv)
                    return rv.permute(0, 3, 1, 2).contiguous()

                y_hats.append(self._walk_slices(
                    latent_means[lo:hi], latent_scales[lo:hi], get_symbols
                ))
                per_sub.append(decoded_k)
            decoded = [_cat([d[i] for d in per_sub]) for i in range(S)]
        return {"x_hat": self._synthesize(y_hats), "symbols": decoded}
