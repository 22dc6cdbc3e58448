"""Convolution core: the f32 stride-1 convolution kernel
(`csrc/conv_tc.cu`, an implicit GEMM on the tensor cores in 3xTF32), its
route and its plain PyTorch version.

The kernel replaces no TPU kernel: the JAX package leaves convolutions to
XLA, and the port left them to cuDNN, whose deterministic f32 algorithms
(TF32 off, for lockstep) run on the FMA pipes. `layers.conv.Conv2d` takes
the kernel where `routes` holds (f32 CUDA tensors, grad mode off, stride 1,
zero padding k // 2 of a square k in `KERNEL_SIZES`) and `F.conv2d`
everywhere else: CPU tensors, bf16, strided convolutions and every call
under autograd.

`routes`, `splits` and `tile_config` are pure functions of dtypes,
devices, grad mode and shapes, and the kernel sums every output in an
order that depends only on C_in and k, so encoder and decoder compute the
same bits at any batch, eagerly or in a CUDA graph. The kernel reads its
weights packed tap-major (`pack_weight`); `layers.conv.Conv2d` keeps the
packing beside its weight until the weight changes.

`conv2d_tc_plain` repeats the kernel's arithmetic (`split_tf32`, three
products) in plain PyTorch; `passes=1` is the single TF32 pass that the
kernel must not use.
"""

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from .. import _native

KERNEL_SIZES = (1, 3, 5)

# `CONV_TC_CONFIGS` of csrc/conv_tc.cu, by index: (BM, BN, blocks an SM).
CONFIGS = ((128, 64, 2), (64, 64, 2), (64, 32, 3), (128, 16, 2), (128, 8, 2))
# each configuration's outputs a second on a filled card, relative to the
# first's (an H100's at the cells' shapes, PERF.md section 6)
_RATE = (1.0, 0.85, 0.69, 0.56, 0.32)
# stages of BK = 32 columns a block of a split-K cluster runs, at least
_STAGES_PER_SPLIT = 24
_MAX_SPLITS = 4


def routes(x, weight, bias, stride, padding, dilation, groups,
           padding_mode="zeros") -> bool:
    """Whether a Conv2d call launches the kernel: x and weight f32 on a
    CUDA device, grad mode off, NCHW x, a square k x k weight with k in
    `KERNEL_SIZES`, stride 1, dilation 1, one group, zero padding k // 2,
    bias f32 or None."""
    if x.device.type != "cuda" or torch.is_grad_enabled():
        return False
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        return False
    k = weight.shape[-1]
    return (x.dim() == 4 and weight.shape[-2] == k and k in KERNEL_SIZES
            and tuple(stride) == (1, 1) and tuple(dilation) == (1, 1)
            and groups == 1 and tuple(padding) == (k // 2, k // 2)
            and padding_mode == "zeros"
            and (bias is None or bias.dtype == torch.float32))


def padded_channels(c_in: int) -> int:
    """C_in rounded up to a multiple of 8: the kernel's channels a tap."""
    return -(-c_in // 8) * 8


def splits(c_in: int, k: int) -> int:
    """The blocks that share an output tile (split K), from C_in and k
    alone, so that every output sums in the same order at any batch: one
    a run of at least `_STAGES_PER_SPLIT` stages, at most `_MAX_SPLITS`."""
    stages = -(-k * k * padded_channels(c_in) // 32)
    return max(1, min(_MAX_SPLITS, stages // _STAGES_PER_SPLIT))


def tile_config(M: int, N: int, split: int, sms: int) -> int:
    """The configuration (index into `CONFIGS`) for a GEMM of M output
    pixels and N output channels, split over `split` blocks, on a card of
    `sms` SMs: the one of least modelled time, its waves of blocks x an
    SM's outputs a wave / its rate (`_RATE`). On an H100 it picked within
    2% of the fastest configuration on average over the cells' shapes
    (PERF.md section 6)."""
    def cost(i):
        bm, bn, per_sm = CONFIGS[i]
        blocks = -(-M // bm) * -(-N // bn) * split
        return -(-blocks // (sms * per_sm)) * per_sm * bm * bn / _RATE[i]

    return min(range(len(CONFIGS)), key=cost)


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def pack_weight(weight):
    """The kernel's B operand of an (N, C, k, k) f32 CUDA weight (N,
    k * k * Cp * 2) f32: column (tap, c) is `split_tf32` of weight[n, c,
    tap] as big part and exact rest, zero for c >= C, Cp =
    `padded_channels(C)`; each group of 8 columns holds the 8 big parts,
    then the 8 small ones, column j at 2 (j % 4) + j // 4 of its half
    (`pack_weight_plain` in plain PyTorch)."""
    dev = weight.device
    N, C, k = weight.shape[0], weight.shape[1], weight.shape[-1]
    _native.check_operand(weight, "weight", torch.float32, dev, (N, C, k, k))
    packed = torch.empty((N, k * k * padded_channels(C) * 2),
                         dtype=torch.float32, device=dev)
    lib = _native.load("convtc")
    with torch.cuda.device(dev):
        rc = lib.stf_conv_tc_pack(weight.data_ptr(), packed.data_ptr(), N, C,
                                  k, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"conv_tc pack failed: {lib.stf_conv_tc_error(rc).decode()}")
    _native.launch_counts["conv_tc_pack"] += 1
    return packed


def pack_weight_plain(weight):
    """`pack_weight` in plain PyTorch."""
    N, C, k = weight.shape[0], weight.shape[1], weight.shape[-1]
    cp = padded_channels(C)
    taps = weight.new_zeros((N, k * k, cp))
    taps[:, :, :C] = weight.permute(0, 2, 3, 1).reshape(N, k * k, C)
    big, _ = split_tf32(taps)
    # columns (group, half, t) -> (group, part, t, half)
    parts = torch.stack([big.reshape(N, -1, 8), (taps - big).reshape(N, -1, 8)],
                        2).reshape(N, -1, 2, 2, 4)
    return parts.permute(0, 1, 2, 4, 3).reshape(N, -1)


def conv2d_tc(x, weight, bias=None, config=None, packed=None):
    """y = conv2d(x, weight, bias, padding=k // 2) by the kernel, on
    contiguous f32 CUDA tensors: x (B, C, H, W), weight (N, C, k, k), bias
    (N,) or None -> (B, N, H, W). `packed` is `pack_weight(weight)` where
    the caller keeps it (packed here otherwise); `config` forces a tile
    configuration (an index into `CONFIGS`), by default `tile_config`'s."""
    dev = x.device
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"conv2d_tc takes x (B, C, H, W) and weight "
                         f"(N, C, k, k), got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    B, C, H, W = x.shape
    N, k = weight.shape[0], weight.shape[-1]
    if k not in KERNEL_SIZES:
        raise ValueError(f"no conv_tc kernel for k={k}")
    check = _native.check_operand
    check(x, "x", torch.float32, dev, (B, C, H, W))
    check(weight, "weight", torch.float32, dev, (N, C, k, k))
    if bias is not None:
        check(bias, "bias", torch.float32, dev, (N,))
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel copies "
                         "16-byte runs)")
    if packed is None:
        packed = pack_weight(weight)
    check(packed, "packed weight", torch.float32, dev,
          (N, k * k * padded_channels(C) * 2))
    split = splits(C, k)
    if config is None:
        config = tile_config(B * H * W, N, split, _sms(dev.index))
    elif not 0 <= config < len(CONFIGS):
        raise ValueError(f"no conv_tc configuration {config}")
    y = torch.empty((B, N, H, W), dtype=torch.float32, device=dev)
    lib = _native.load("convtc")
    with torch.cuda.device(dev):
        rc = lib.stf_conv_tc(
            x.data_ptr(), packed.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            B, C, H, W, N, k, config, split,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"conv_tc launch failed: {lib.stf_conv_tc_error(rc).decode()}")
    _native.launch_counts[launch_key(k)] += 1
    return y


def launch_key(k: int) -> str:
    """The `_native.launch_counts` key of the kernel at k x k."""
    return f"conv_tc_k{k}"


def split_tf32(t, rounded: bool = True):
    """(big, small) of f32 `t` as the kernel splits it, as the tensor core
    reads them: big is t rounded to TF32 (its low 13 bits cleared, ties
    away from zero; with `rounded` False, truncated, as the kernel splits
    x), small the rest with its low 13 bits dropped."""
    mask = -(1 << 13)
    bits = t.contiguous().view(torch.int32)
    big = ((bits + (1 << 12) if rounded else bits) & mask).view(torch.float32)
    small = ((t - big).view(torch.int32) & mask).view(torch.float32)
    return big, small


def conv2d_tc_plain(x, weight, bias=None, passes: int = 3):
    """The kernel's arithmetic in plain PyTorch (f32, TF32 off): the sum
    of the products small*big', big*small' and big*big' of the split
    operands (each exact in f32; x's split truncated, the weights'
    rounded), then the bias; `passes=1` keeps big*big' alone, a single
    TF32 pass."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    pad = weight.shape[-1] // 2
    xb, xs = split_tf32(x, rounded=False)
    wb, ws = split_tf32(weight)
    y = F.conv2d(xb, wb, padding=pad)
    if passes == 3:
        y = F.conv2d(xs, wb, padding=pad) + F.conv2d(xb, ws, padding=pad) + y
    return y if bias is None else y + bias[:, None, None]


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.stf_conv_tc_configs.restype = ctypes.c_int
    lib.stf_conv_tc_configs.argtypes = []
    lib.stf_conv_tc.restype = ctypes.c_int
    lib.stf_conv_tc.argtypes = [vp, vp, vp, vp] + [i32] * 8 + [vp]
    lib.stf_conv_tc_pack.restype = ctypes.c_int
    lib.stf_conv_tc_pack.argtypes = [vp, vp, i32, i32, i32, vp]
    lib.stf_conv_tc_error.restype = ctypes.c_char_p
    lib.stf_conv_tc_error.argtypes = [ctypes.c_int]


_native.declare("convtc", _declare)
