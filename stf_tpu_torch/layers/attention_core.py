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
"""

import ctypes

import torch

from .. import _native


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
        with torch.profiler.record_function("window_attention_backward"):
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


# the bf16 instances' two designs for the products, by the entry point's
# `design` argument: bf16 mma.sync (the codec's) and TF32 on the converted
# values (kept so that the smoke times the two side by side)
BF16_DESIGNS = {"bf16_mma": 0, "tf32": 1}


def _launch(qkv, bias, labels, window: int, scale: float,
            design: str = "bf16_mma"):
    """Kernel B1 on CUDA tensors, after checking every operand; `design`
    picks the bf16 instances' products (`BF16_DESIGNS`)."""
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
    if not lib.stf_window_attention_supported(N, C // nh):
        raise ValueError(
            f"no window_attention kernel for N={N}, head dim {C // nh}"
        )
    out = torch.empty((B, H, W, C), dtype=dtype, device=dev)
    lab = None if labels is None else labels.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dtype == torch.bfloat16:
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
    _native.launch_counts[launch_key(ws, C // nh, dtype)] += 1
    return out


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
    lib.stf_window_attention_error.restype = ctypes.c_char_p
    lib.stf_window_attention_error.argtypes = [ctypes.c_int]


_native.declare("winattn", _declare)
