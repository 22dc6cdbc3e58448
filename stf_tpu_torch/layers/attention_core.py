"""Window-attention core: kernel B1 (`csrc/window_attention.cu`) and its
plain PyTorch version.

Port of `stf_tpu/layers/pallas_attention.py`. For every window and head:
softmax(q*scale . k^T + relpos_bias[h] + shift_penalty[w]) . v, in f32, or
on bf16 qkv and bias as the JAX core computes in its inputs' dtype: q*scale
rounded to bf16 (the scale rounded to bf16 first, as JAX rounds a Python
float that meets a bf16 array), bf16 products summed in f32, the bias
added and the softmax taken in f32, P . v in f32 (v promoted), the output
rounded to bf16. The JAX codec's bf16 analysis runs this
(`Codec(dtype=torch.bfloat16)`); its synthesis stays f32.

Unlike the Pallas kernel, which takes window-partitioned (B*nW, nh, N, hd)
q/k/v and a (B*nW, N, N) mask, `window_attention` reads q, k and v straight
from the (B, H, W, 3C) qkv projection of the (rolled) NHWC map and writes
the head-concatenated (B, H, W, C) result at the same pixels; the shift
penalty (-100 across shift regions, the reference's SW-MSA value) comes
from the (nW, N) per-token region labels. Windows are computed one by one
(the JAX module's packing of several windows per 128-token tile is a TPU
device and has no counterpart here).

Gradients. On CUDA tensors that need a gradient, `window_attention` runs
B1 inside `WindowAttentionFunction`: the forward launches the kernel as
the eval path does and saves qkv, bias and labels; the backward
recomputes the softmax from them in PyTorch ops and returns d qkv and
d bias by the closed form (`window_attention_backward`). The JAX package
has no backward kernel for `_attn_kernel` either (it trains through its
plain core), so B1 has none. Every CUDA call goes through the Function:
under `torch.no_grad()`, inference mode and the codec's CUDA-graph
captures it records no graph and launches B1 once, as a direct call
would. A bf16 call that needs a gradient raises: the JAX trainer trains
in f32 only.

Each launch adds its FLOPs, by design, to the codec call that records
(`count_flops`, `utils/tracing.py`), or to the CUDA-graph capture in
progress, whose replays add them.
"""

import ctypes
import functools

import torch

from .. import _native
from ..utils import tracing


def partition_qkv(qkv: torch.Tensor, window: int, num_heads: int):
    """(B, H, W, 3C) -> q, k, v each (B*nW, nh, N, hd), windows in
    row-major (p, q) order and tokens row-major inside a window."""
    B, H, W, C3 = qkv.shape
    C, ws = C3 // 3, window
    hd = C // num_heads
    t = qkv.reshape(B, H // ws, ws, W // ws, ws, 3, num_heads, hd)
    t = t.permute(5, 0, 1, 3, 6, 2, 4, 7)
    t = t.reshape(3, B * (H // ws) * (W // ws), num_heads, ws * ws, hd)
    return t[0], t[1], t[2]


def unpartition(out: torch.Tensor, B: int, H: int, W: int, window: int):
    """(B*nW, nh, N, hd) -> (B, H, W, nh*hd)."""
    ws = window
    _, nh, _, hd = out.shape
    out = out.reshape(B, H // ws, W // ws, nh, ws, ws, hd)
    return out.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, H, W, nh * hd)


def shift_penalty(labels: torch.Tensor) -> torch.Tensor:
    """(nW, N) region labels -> (nW, N, N) additive 0 / -100 mask."""
    diff = labels[:, :, None] != labels[:, None, :]
    return torch.where(diff, -100.0, 0.0).to(torch.float32)


def partition(x: torch.Tensor, window: int, num_heads: int):
    """(B, H, W, C) -> (B*nW, nh, N, hd), the layout of `partition_qkv`'s
    q, k and v."""
    B, H, W, C = x.shape
    ws, hd = window, C // num_heads
    t = x.reshape(B, H // ws, ws, W // ws, ws, num_heads, hd)
    return t.permute(0, 1, 3, 5, 2, 4, 6).reshape(-1, num_heads, ws * ws, hd)


def bf16_scale(scale: float) -> float:
    """`scale` rounded to bf16: what a Python float becomes when JAX
    multiplies a bf16 array by it."""
    return float(torch.tensor(scale, dtype=torch.bfloat16))


def _probs(q, k, bias, labels, B: int, scale: float):
    """softmax(q*scale . k^T + bias[h] + shift penalty) over windows; for
    bf16 inputs q*scale rounds to bf16 and the rest runs in f32."""
    if q.dtype == torch.bfloat16:
        q = (q * bf16_scale(scale)).float()
        k, bias, scale = k.float(), bias.float(), 1.0
    attn = torch.matmul(q * scale, k.transpose(-2, -1))  # (B*nW, nh, N, N)
    attn = attn + bias[None]
    if labels is not None:
        nW, N = labels.shape
        nh = bias.shape[0]
        attn = (
            attn.reshape(B, nW, nh, N, N) + shift_penalty(labels)[None, :, None]
        ).reshape(attn.shape)
    return torch.softmax(attn, dim=-1)


def window_attention_plain(qkv, bias, labels, window: int, scale: float):
    """Plain PyTorch version of kernel B1 (same signature and layouts)."""
    B, H, W, _ = qkv.shape
    q, k, v = partition_qkv(qkv, window, bias.shape[0])
    attn = _probs(q, k, bias, labels, B, scale)
    out = torch.matmul(attn, v.to(attn.dtype)).to(qkv.dtype)
    return unpartition(out, B, H, W, window)


def window_attention_backward(qkv, bias, labels, window: int, scale: float,
                              grad_out):
    """(d qkv, d bias) of `window_attention_plain` at these inputs for the
    output gradient `grad_out` (B, H, W, C), by the closed form: with
    P = softmax(S) and dO the window-partitioned grad_out,
    dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dP * P)),
    dq = scale dS k, dk = scale dS^T q, d bias = dS summed over windows.
    P is recomputed from qkv, bias and labels."""
    B, H, W, _ = qkv.shape
    nh = bias.shape[0]
    q, k, v = partition_qkv(qkv, window, nh)
    p = _probs(q, k, bias, labels, B, scale)
    do = partition(grad_out, window, nh)
    dv = torch.matmul(p.transpose(-2, -1), do)
    dp = torch.matmul(do, v.transpose(-2, -1))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-2, -1), q) * scale
    dqkv = torch.cat([unpartition(t, B, H, W, window) for t in (dq, dk, dv)],
                     dim=-1)
    return dqkv, ds.sum(0)


class WindowAttentionFunction(torch.autograd.Function):
    """B1 with a gradient: the forward is the kernel (the plain version for
    CPU tensors), the backward `window_attention_backward`. Labels, window
    and scale take no gradient; a bf16 call that needs one raises."""

    @classmethod
    def apply(cls, qkv, bias, *args):
        if qkv.dtype == torch.bfloat16 and torch.is_grad_enabled() and (
                qkv.requires_grad or bias.requires_grad):
            raise NotImplementedError(
                "B1 has no bf16 gradient: the trainer runs in f32")
        return super().apply(qkv, bias, *args)

    @staticmethod
    def forward(ctx, qkv, bias, labels, window: int, scale: float):
        ctx.save_for_backward(qkv, bias, labels)
        ctx.window, ctx.scale = window, scale
        if qkv.device.type == "cpu":
            return window_attention_plain(qkv, bias, labels, window, scale)
        return _launch(qkv, bias, labels, window, scale)

    @staticmethod
    def backward(ctx, grad_out):
        qkv, bias, labels = ctx.saved_tensors
        # a profiler range, so a trace can separate B1's backward
        with tracing.profiler_range("window_attention_backward"):
            dqkv, dbias = window_attention_backward(
                qkv, bias, labels, ctx.window, ctx.scale, grad_out
            )
        return (dqkv if ctx.needs_input_grad[0] else None,
                dbias if ctx.needs_input_grad[1] else None, None, None, None)


def window_attention(qkv, bias, labels, window: int, scale: float):
    """Attention over ws x ws windows of the (B, H, W, 3C) f32 or bf16 qkv
    map -> (B, H, W, C) of its dtype. bias: (nh, N, N) gathered
    relative-position bias of qkv's dtype;
    labels: (nW, N) int32 shift-region labels, or None for unshifted
    windows. On CUDA tensors this launches kernel B1 through
    `WindowAttentionFunction`; on CPU tensors it runs
    `window_attention_plain`, which autograd differentiates (in f32)."""
    if qkv.device.type == "cpu":
        if qkv.dtype == torch.bfloat16:
            return WindowAttentionFunction.apply(qkv, bias, labels, window,
                                                 scale)
        return window_attention_plain(qkv, bias, labels, window, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"window_attention runs on cuda or cpu, not {qkv.device}")
    return WindowAttentionFunction.apply(qkv, bias, labels, window, scale)


# B1's designs, by `_launch`'s `design` argument. One block per (window,
# head): "window_head" in f32 (3xTF32 mma.sync), and in bf16 "bf16_mma"
# (bf16 mma.sync) or "tf32" (TF32 on the converted values). One block per
# head group that walks windows: "head_group", at TBC's 8x8 geometries
# (`HEAD_GROUP_WIDTHS`, heads a multiple of the group), in both dtypes.
# `main_design` is the one the wrapper launches; the others stay callable
# so that the smoke times them side by side on one card.
BF16_DESIGNS = {"bf16_mma": 0, "tf32": 1}
HEAD_GROUP = "head_group"
HEAD_GROUP_WIDTHS = (4, 6, 8, 10)  # at 8x8 windows


def head_group_fits(window: int, head_dim: int, num_heads: int,
                    group: int) -> bool:
    """Whether the head-group design has an instance for this geometry."""
    return (window == 8 and head_dim in HEAD_GROUP_WIDTHS
            and num_heads % group == 0)


def main_design(window: int, head_dim: int, num_heads: int, dtype,
                group: int) -> str:
    """The design the wrapper launches: the head group's at TBC's 8x8
    geometries (faster there on an H100, PERF.md section 6), else one
    block per (window, head)."""
    if head_group_fits(window, head_dim, num_heads, group):
        return HEAD_GROUP
    return "bf16_mma" if dtype == torch.bfloat16 else "window_head"


def head_group_plan(windows: int, num_heads: int, group: int, sms: int,
                    blocks_per_sm: int):
    """(head groups, window chunks) of a head-group launch over `windows`
    windows (batch x windows an image): one block per (head group, chunk),
    as many chunks as fill the card's resident blocks once, at most one a
    window. Block j takes head group j % groups and chunk j // groups."""
    groups = num_heads // group
    chunks = max(1, min(windows, sms * blocks_per_sm // groups))
    return groups, chunks


def head_group_walk(chunk: int, chunks: int, windows: int):
    """The windows (flat, batch-major) that block chunk `chunk` walks, in
    order, as the kernel walks them: step i takes window
    i * chunks + (chunk + i) % chunks, so every step's blocks share one
    run of `chunks` windows and the windows of a column (a shifted map's
    mixed last column) fall on every chunk in turn."""
    full, rest = divmod(windows, chunks)
    count = full + ((chunk + full) % chunks < rest)
    return [i * chunks + (chunk + i) % chunks for i in range(count)]


@functools.cache
def _head_group_shape(device_index: int, head_dim: int, bf16: bool):
    """(heads a block, blocks an SM, SMs) of the head-group instance on a
    card, read once per (card, width, dtype): the codec's first call of a
    shape runs eagerly, so no CUDA-graph capture queries the card."""
    lib = _native.load("winattn")
    group = lib.stf_window_attention_head_group_heads()
    with torch.cuda.device(device_index):
        blocks = lib.stf_window_attention_head_group_blocks(head_dim, int(bf16))
    if blocks < 1:
        raise RuntimeError(
            f"head-group window_attention for head dim {head_dim} fits no "
            f"block on the card ({blocks})")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return group, blocks, sms


def _launch(qkv, bias, labels, window: int, scale: float, design=None):
    """Kernel B1 on CUDA tensors, after checking every operand; `design`
    picks one of B1's designs (the note above `BF16_DESIGNS`), by default
    `main_design`'s."""
    dev = qkv.device
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, H, W, 3C), got {tuple(qkv.shape)}")
    B, H, W, C3 = qkv.shape
    C, ws, nh = C3 // 3, int(window), bias.shape[0]
    N = ws * ws
    if H % ws or W % ws or C % nh:
        raise ValueError("H and W must be window multiples and C divisible by heads")
    dtype = qkv.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv must be torch.float32 or torch.bfloat16, got "
                        f"{dtype}")
    check = _native.check_operand
    check(qkv, "qkv", dtype, dev, (B, H, W, C3))
    check(bias, "bias", dtype, dev, (nh, N, N))
    if labels is not None:
        check(labels, "labels", torch.int32, dev, ((H // ws) * (W // ws), N))
    if qkv.data_ptr() % 16 or bias.data_ptr() % (2 * bias.element_size()):
        raise ValueError(
            "qkv must be 16-byte and bias pair-aligned (kernel B1 reads "
            "16-byte runs of qkv and pairs of bias values)"
        )
    lib = _native.load("winattn")
    hd = C // nh
    if not lib.stf_window_attention_supported(N, hd):
        raise ValueError(
            f"no window_attention kernel for N={N}, head dim {hd}"
        )
    bf16 = dtype == torch.bfloat16
    tbc = ws == 8 and hd in HEAD_GROUP_WIDTHS  # the head group's widths
    if tbc:
        group, blocks, sms = _head_group_shape(dev.index, hd, bf16)
    if design is None:
        design = main_design(ws, hd, nh, dtype, group if tbc else 1)
    if design == HEAD_GROUP:
        if not (tbc and head_group_fits(ws, hd, nh, group)):
            raise ValueError(f"no head-group window_attention kernel for "
                             f"N={N}, head dim {hd}, {nh} heads")
        if 8 * W * C3 >= 2 ** 31:
            raise ValueError("the head-group design takes maps of 8 W 3C "
                             "below 2^31 elements (32-bit offsets in a window)")
        if bias.data_ptr() % 16 or (labels is not None
                                    and labels.data_ptr() % 16):
            raise ValueError("bias and labels must be 16-byte aligned (the "
                             "head-group design stages them with 16-byte "
                             "copies)")
        _, chunks = head_group_plan(B * (H // ws) * (W // ws), nh, group,
                                    sms, blocks)
    elif design not in (BF16_DESIGNS if bf16 else ("window_head",)):
        raise ValueError(f"no {design!r} design of window_attention in "
                         f"{dtype}")
    out = torch.empty((B, H, W, C), dtype=dtype, device=dev)
    lab = None if labels is None else labels.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if design == HEAD_GROUP:
            rc = lib.stf_window_attention_head_group(
                qkv.data_ptr(), bias.data_ptr(), lab, out.data_ptr(),
                B, H, W, ws, C, nh, bf16_scale(scale) if bf16 else float(scale),
                int(bf16), chunks, stream,
            )
        elif bf16:
            rc = lib.stf_window_attention_bf16(
                qkv.data_ptr(), bias.data_ptr(), lab, out.data_ptr(),
                B, H, W, ws, C, nh, bf16_scale(scale), BF16_DESIGNS[design],
                stream,
            )
        else:
            rc = lib.stf_window_attention(
                qkv.data_ptr(), bias.data_ptr(), lab, out.data_ptr(),
                B, H, W, ws, C, nh, float(scale), stream,
            )
    if rc != 0:
        raise RuntimeError(
            "window_attention launch failed: "
            f"{lib.stf_window_attention_error(rc).decode()}"
        )
    _native.launch_counts[launch_key(ws, hd, dtype)] += 1
    count_flops(design, B, H, W, C, ws)
    return out


def count_flops(design: str, B: int, H: int, W: int, C: int, window: int):
    """Adds one launch's FLOPs, 4 N B H W C (q k^T and P v, N tokens a
    window), under its design to the capture in progress or the open
    codec call's record (`tracing.flop_counter`); nothing where neither
    is open."""
    counter = tracing.flop_counter()
    if counter is not None:
        tracing.count_b1(counter, design == HEAD_GROUP,
                         4 * window * window * B * H * W * C)


def launch_key(window: int, head_dim: int, dtype=torch.float32) -> str:
    """The `_native.launch_counts` key of B1's instance for a window,
    head width and dtype: window_attention_ws8_hd24, ..._bf16."""
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    return f"window_attention_ws{window}_hd{head_dim}{suffix}"


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.stf_window_attention_supported.restype = ctypes.c_int
    lib.stf_window_attention_supported.argtypes = [i32, i32]
    lib.stf_window_attention.restype = ctypes.c_int
    lib.stf_window_attention.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, ctypes.c_float, vp,
    ]
    lib.stf_window_attention_bf16.restype = ctypes.c_int
    lib.stf_window_attention_bf16.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, ctypes.c_float, i32,
        vp,
    ]
    lib.stf_window_attention_head_group_heads.restype = ctypes.c_int
    lib.stf_window_attention_head_group_heads.argtypes = []
    lib.stf_window_attention_head_group_blocks.restype = ctypes.c_int
    lib.stf_window_attention_head_group_blocks.argtypes = [i32, i32]
    lib.stf_window_attention_head_group.restype = ctypes.c_int
    lib.stf_window_attention_head_group.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, ctypes.c_float, i32,
        i32, vp,
    ]
    lib.stf_window_attention_error.restype = ctypes.c_char_p
    lib.stf_window_attention_error.argtypes = [ctypes.c_int]


_native.declare("winattn", _declare)
