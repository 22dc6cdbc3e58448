"""The yardstick's arithmetic: the card's peaks, a kernel's least time
from the bytes and operations its call needs, the FLOPs of a codec phase,
the union of device intervals, and the tail percentile.

Copied from the repository's chip smoke (`bound`, the B1-B3 byte and
operation counts behind PERF.md's kernel table, `kernel_group`) and from
the program's FLOP convention (`utils/flops.py`: torch's FlopCounterMode,
window attention counted as 2 x 2 x tokens x window tokens x channels),
so that later changes to the program cannot move them.
"""

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from ..reference import models as ref_models

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # bf16 tensor cores, dense
PEAK = {"float32": F32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}

# the lane stream's format: 8 groups of 128 interleaved rANS lanes a
# segment; the scale table's 64 rows of a 127-symbol window (128 CDF
# entries of 4 bytes)
LANE_GROUPS, LANES = 8, 128
LANE_TABLE_BYTES = 64 * 128 * 4


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> float:
    """The least time of a call: the larger of its bytes over the memory
    rate and its operations over `ops_per_s`."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s) * 1e3


def b1_bound_ms(qkv_shape: Sequence[int], window: int, heads: int,
                shifted: bool, dtype: str) -> float:
    """Kernel B1 on a (B, H, W, 3C) qkv: qkv read and the (B, H, W, C)
    output written once, the (heads, N, N) bias and, when shifted, the
    (windows, N) int32 region labels read once; 4 N C operations a token
    (q k^T and P v, 2 each)."""
    B, H, W, C3 = qkv_shape
    C, N, e = C3 // 3, window * window, ELEMENT_BYTES[dtype]
    nW = (H // window) * (W // window)
    nbytes = B * H * W * 4 * C * e + heads * N * N * e + (nW * N * 4 if shifted else 0)
    return bound_ms(nbytes, 4 * N * B * H * W * C, PEAK[dtype])


def lane_decode_bound_ms(symbols: int, stream_bytes: int, segments: int) -> float:
    """Kernel B2 over a call's segments: the int32 indexes in and symbols
    out, the stream's words and escapes, each lane's state and the CDF
    table once a segment; ~30 integer operations a symbol."""
    nbytes = (8 * symbols + stream_bytes
              + segments * (4 * LANE_GROUPS * LANES + LANE_TABLE_BYTES))
    return bound_ms(nbytes, 30 * symbols)


def lane_encode_bound_ms(symbols: int, stream_bytes: int, segments: int) -> float:
    """Kernel B3 over a call's segments: int32 symbols and indexes in, the
    stream's words and escapes, each lane's state and each row group's
    counts out, the CDF table once a segment; ~40 integer operations a
    symbol."""
    nbytes = (8 * symbols + stream_bytes
              + segments * (4 * LANE_GROUPS * LANES * 2 + LANE_TABLE_BYTES))
    return bound_ms(nbytes, 40 * symbols)


def kernel_group(name: str) -> str:
    """A device operation's kind by its name: B1-B4, convolution (cuDNN's
    implicit-GEMM, FFT (with its complex products), direct and Winograd
    kernels), other GEMM, copy, or the rest."""
    k = name.lower()
    if "window_attention" in k:
        return "B1"
    if "lane_decode" in k:
        return "B2"
    if "lane_encode" in k:
        return "B3"
    if k.startswith(("pin_packed", "pin_transpose", "pin_general")) or "void pin_" in k:
        return "B4"
    if any(t in k for t in ("implicit_gemm", "cudnn", "fft", "dgrad", "wgrad",
                            "conv", "winograd", "cf32", "region_transform",
                            "pointwise_mult_and_sum_complex")):
        return "convolution"
    if "gemm" in k:
        return "gemm"
    if "memcpy" in k or "memset" in k:
        return "copy"
    return "other"


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the intervals, overlaps counted once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def p95(values: Sequence[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def phase_costs(model: str, arch: dict, codec: dict, batch: int,
                hw: Tuple[int, int], flops: bool = True) -> Dict[str, dict]:
    """Per phase ("encode", "decode") of one call at (batch, H, W): the
    FLOPs by dtype ("float32" / "bfloat16") and B1's launches as
    (qkv shape, window, heads, shifted, dtype), counted on the reference
    on the meta device (shapes only). The encoder runs the analysis (in
    the codec's dtype, in `analyze_chunks` sub-batches), the hyper
    synthesis and the walk without the last slice's residual prediction;
    the decoder the hyper synthesis, the whole walk and the synthesis (in
    `synth_chunks`). With `flops` False only B1's launches are counted
    (the FLOPs read 0), which takes a fraction of the time."""
    import contextlib

    from torch.utils.flop_counter import FlopCounterMode

    ref = ref_models.build(model, arch, device="meta")
    adtype = codec.get("dtype", "float32")
    H, W = hw

    def chunks(n):
        return n if n > 1 and batch % n == 0 else 1

    ca, cs = chunks(codec.get("analyze_chunks", 1)), chunks(codec.get("synth_chunks", 1))
    launches: List[tuple] = []
    dtype_now = ["float32"]  # the dtype of the stage being counted

    def observe(mod, shape, shift):
        launches.append((shape, mod.ws, mod.heads, bool(shift), dtype_now[0]))

    for m in ref_models.attention_modules(ref):
        m.observer = observe

    def count(fn, dtype, repeat=1):
        """(fn's output, its FLOPs x repeat, its B1 launches x repeat)."""
        dtype_now[0] = dtype
        launches.clear()
        fc = FlopCounterMode(display=False) if flops else contextlib.nullcontext()
        with fc, torch.no_grad():
            out = fn()
        total = fc.get_total_flops() if flops else 0
        return out, total * repeat, launches * repeat

    x = torch.empty(batch // ca, 3, H, W, device="meta")
    (y, z), f_an, b1_an = count(lambda: ref.analyze(x), adtype, ca)
    y = torch.empty(batch, *y.shape[1:], device="meta")
    z_hat = torch.empty(batch, *z.shape[1:], device="meta")
    (lm, ls), f_hyper, b1_hyper = count(lambda: ref.hyper(z_hat, y.shape[2:]),
                                        "float32")

    def walk(last_lrp):
        decoded = []
        for i, _ in enumerate(ref.split(y)):
            mu, _, ms = ref.slice_mu_scale(i, lm, ls, ref.support(decoded))
            if last_lrp or i < ref.num_slices - 1:
                decoded.append(mu + ref.lrp(i, ms, mu))
            else:
                decoded.append(mu)
        return torch.cat(decoded, 1)

    _, f_walk_enc, b1_walk = count(lambda: walk(False), "float32")
    y_hat, f_walk_dec, _ = count(lambda: walk(True), "float32")
    y_part = y_hat[: batch // cs]
    _, f_syn, b1_syn = count(lambda: ref.synthesize(y_part), "float32", cs)
    enc = {"float32": f_hyper + f_walk_enc}
    enc[adtype] = enc.get(adtype, 0) + f_an
    return {
        "encode": {"flops": enc, "b1": b1_an + b1_hyper + b1_walk},
        "decode": {"flops": {"float32": f_hyper + f_walk_dec + f_syn},
                   "b1": b1_hyper + b1_walk + b1_syn},
    }


def flop_seconds(flops_by_dtype: Dict[str, float]) -> float:
    """The least time of FLOPs at each dtype's peak, summed."""
    return sum(n / PEAK[d] for d, n in flops_by_dtype.items())
