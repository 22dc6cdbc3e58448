"""Convolution core: the f32 stride-1 convolution kernel
(`csrc/conv_tc.cu`, an implicit GEMM on the tensor cores in 3xTF32), its
route and its plain PyTorch version; and the same kernel's transposed
convolution (5x5, stride 2, padding 2, output padding 1: the synthesis
transforms' exact 2x upsampler) as four sub-pixel phases.

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

The transposed convolution replaces cuDNN's backward-data kernels, which
the port's `deconv` layers took before. Output row 2m + py, column 2n + px
of it is a stride-1 correlation of x with the phase's (3 - py) x (3 - px)
sub-kernel (`phase_kernels`: the taps of parity py, px, flipped), over
the taps of a 3x3 window (padding 1) at rows >= py and columns >= px. The
kernel runs the four phases in one launch in one of two forms that
`deconv_joint` picks from C_out: one GEMM a phase over its own taps (exact
FLOPs), or one GEMM of 4 C_out columns over the whole window
(`joint_kernel`, the absent taps zero), which reads x once where C_out is
small. `routes_transposed` is its route (`layers.conv.ConvTranspose2d`);
`conv_transpose2d_phases` is the decomposition in plain PyTorch, and
`conv_transpose2d_tc_plain` the kernel's arithmetic on it.
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


def routes_transposed(x, weight, bias, stride, padding, output_padding,
                      dilation, groups, padding_mode="zeros") -> bool:
    """Whether a ConvTranspose2d call launches the kernel: x and weight f32
    on a CUDA device, grad mode off, NCHW x, a 5x5 weight, stride 2,
    padding 2, output padding 1, dilation 1, one group, zero padding, bias
    f32 or None."""
    if x.device.type != "cuda" or torch.is_grad_enabled():
        return False
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        return False
    return (x.dim() == 4 and tuple(weight.shape[-2:]) == (5, 5)
            and tuple(stride) == (2, 2) and tuple(padding) == (2, 2)
            and tuple(output_padding) == (1, 1)
            and tuple(dilation) == (1, 1) and groups == 1
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


def tile_config(M: int, N: int, split: int, sms: int, gemms: int = 1) -> int:
    """The configuration (index into `CONFIGS`) for `gemms` GEMMs (the
    transposed convolution's phases) of M output pixels and N output
    channels each, split over `split` blocks, on a card of `sms` SMs: the
    one of least modelled time, its waves of blocks x an SM's outputs a
    wave / its rate (`_RATE`). On an H100 it picked within 2% of the
    fastest configuration on average over the cells' shapes (PERF.md
    section 6)."""
    def cost(i):
        bm, bn, per_sm = CONFIGS[i]
        blocks = -(-M // bm) * -(-N // bn) * split * gemms
        return -(-blocks // (sms * per_sm)) * per_sm * bm * bn / _RATE[i]

    return min(range(len(CONFIGS)), key=cost)


# the transposed convolution's phases (py, px) in the kernel's order, and
# the taps of each: (3 - py) x (3 - px) of the 3x3 window
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
PHASE_TAPS = tuple((3 - py) * (3 - px) for py, px in PHASES)


def deconv_joint(c_out: int) -> bool:
    """Whether the kernel computes a transposed convolution's four phases
    as one GEMM of 4 C_out columns over the whole 3x3 window (x gathered
    once, the absent taps' products too) rather than one GEMM a phase of
    C_out columns over its own taps: the form of least modelled time a
    pixel of x, each at its best configuration of `CONFIGS`, taps x N
    rounded up to the tile's width / the configuration's rate (`_RATE`).
    From C_out alone, so the form, and with it each output's order of
    summation, does not depend on the batch."""
    def cost(n, taps):
        return min(taps * -(-n // bn) * bn / rate
                   for (_, bn, _), rate in zip(CONFIGS, _RATE))

    return cost(4 * c_out, 9) < cost(c_out, sum(PHASE_TAPS))


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def pack_weight(weight, round_small: bool = False):
    """The kernel's B operand of an (N, C, kh, kw) f32 CUDA weight (N,
    kh * kw * Cp * 2) f32: column (tap, c) is `split_tf32` of weight[n, c,
    tap] as big part and exact rest (taps in row-major order; the rest
    rounded to TF32 with `round_small`, as the transposed convolution
    reads it), zero for c >= C, Cp = `padded_channels(C)`; each group of 8
    columns holds the 8 big parts, then the 8 small ones, column j at
    2 (j % 4) + j // 4 of its half (`pack_weight_plain` in plain
    PyTorch)."""
    dev = weight.device
    N, C, kh, kw = weight.shape
    _native.check_operand(weight, "weight", torch.float32, dev, (N, C, kh, kw))
    packed = torch.empty((N, kh * kw * padded_channels(C) * 2),
                         dtype=torch.float32, device=dev)
    lib = _native.load("convtc")
    with torch.cuda.device(dev):
        rc = lib.stf_conv_tc_pack(weight.data_ptr(), packed.data_ptr(), N, C,
                                  kh * kw, int(round_small),
                                  torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"conv_tc pack failed: {lib.stf_conv_tc_error(rc).decode()}")
    _native.launch_counts["conv_tc_pack"] += 1
    return packed


def pack_weight_plain(weight, round_small: bool = False):
    """`pack_weight` in plain PyTorch."""
    N, C, kh, kw = weight.shape
    cp = padded_channels(C)
    taps = weight.new_zeros((N, kh * kw, cp))
    taps[:, :, :C] = weight.permute(0, 2, 3, 1).reshape(N, kh * kw, C)
    big, _ = split_tf32(taps)
    small = taps - big
    if round_small:
        small = _round_tf32(small)
    # columns (group, half, t) -> (group, part, t, half)
    parts = torch.stack([big.reshape(N, -1, 8), small.reshape(N, -1, 8)],
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


def phase_kernels(weight):
    """The four phases' correlation kernels of a transposed convolution's
    (C_in, C_out, 5, 5) weight, in `PHASES` order: phase (py, px)'s is
    (C_out, C_in, 3 - py, 3 - px), the taps of parity (py, px) flipped, so
    that its tap (i, j) multiplies x at (h + py + i - 1, w + px + j - 1)
    for output (2h + py, 2w + px)."""
    return [weight[:, :, py::2, px::2].flip(2, 3).transpose(0, 1).contiguous()
            for py, px in PHASES]


def joint_kernel(weight):
    """The joint form's (4 C_out, C_in, 3, 3) kernel: row 4 co + 2 py + px
    holds phase (py, px)'s kernel at the window's rows >= py and columns
    >= px, zeros elsewhere."""
    c_in, c_out = weight.shape[:2]
    out = weight.new_zeros((c_out, 4, c_in, 3, 3))
    for p, ((py, px), k) in enumerate(zip(PHASES, phase_kernels(weight))):
        out[:, p, :, py:, px:] = k
    return out.reshape(4 * c_out, c_in, 3, 3)


def deconv_pack_weight(weight, joint=None):
    """The kernel's B operand of a transposed convolution's (C_in, C_out,
    5, 5) f32 CUDA weight, flat, its small parts rounded to TF32: in the
    joint form (by default `deconv_joint(C_out)`)
    `pack_weight(joint_kernel(weight))`, else the four
    `pack_weight(phase_kernels(weight)[p])` one after another."""
    if joint is None:
        joint = deconv_joint(weight.shape[1])
    if joint:
        return pack_weight(joint_kernel(weight), round_small=True).reshape(-1)
    return torch.cat([pack_weight(k, round_small=True).reshape(-1)
                      for k in phase_kernels(weight)])


def conv_transpose2d_tc(x, weight, bias=None, config=None, packed=None,
                        joint=None):
    """y = conv_transpose2d(x, weight, bias, stride=2, padding=2,
    output_padding=1) by the kernel, on contiguous f32 CUDA tensors: x (B,
    C_in, H, W), weight (C_in, C_out, 5, 5), bias (C_out,) or None -> (B,
    C_out, 2H, 2W), in one launch. `joint` forces the form (by default
    `deconv_joint(C_out)`'s); `packed` is `deconv_pack_weight(weight,
    joint)` where the caller keeps it (packed here otherwise); `config`
    forces a tile configuration (an index into `CONFIGS`), by default
    `tile_config`'s."""
    dev = x.device
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"conv_transpose2d_tc takes x (B, C, H, W) and "
                         f"weight (C, N, 5, 5), got {tuple(x.shape)} and "
                         f"{tuple(weight.shape)}")
    B, C, H, W = x.shape
    N = weight.shape[1]
    check = _native.check_operand
    check(x, "x", torch.float32, dev, (B, C, H, W))
    check(weight, "weight", torch.float32, dev, (C, N, 5, 5))
    if bias is not None:
        check(bias, "bias", torch.float32, dev, (N,))
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel copies "
                         "16-byte runs)")
    if joint is None:
        joint = deconv_joint(N)
    if packed is None:
        packed = deconv_pack_weight(weight, joint)
    taps = 36 if joint else sum(PHASE_TAPS)
    check(packed, "packed weight", torch.float32, dev,
          (N * taps * padded_channels(C) * 2,))
    split = splits(C, 3)
    if config is None:
        config = (tile_config(B * H * W, 4 * N, split, _sms(dev.index))
                  if joint else
                  tile_config(B * H * W, N, split, _sms(dev.index), gemms=4))
    elif not 0 <= config < len(CONFIGS):
        raise ValueError(f"no conv_tc configuration {config}")
    y = torch.empty((B, N, 2 * H, 2 * W), dtype=torch.float32, device=dev)
    lib = _native.load("convtc")
    with torch.cuda.device(dev):
        rc = lib.stf_conv_tc_deconv(
            x.data_ptr(), packed.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            B, C, H, W, N, int(joint), config, split,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"conv_tc deconv launch failed: {lib.stf_conv_tc_error(rc).decode()}")
    _native.launch_counts[deconv_launch_key(joint)] += 1
    return y


def deconv_launch_key(joint: bool) -> str:
    """The `_native.launch_counts` key of the transposed convolution in
    the joint form or the phases form."""
    return "conv_tc_deconv_joint" if joint else "conv_tc_deconv_phases"


def _round_tf32(t):
    """f32 `t` rounded to TF32: its low 13 bits cleared, ties away from
    zero."""
    return ((t.contiguous().view(torch.int32) + (1 << 12)) & -(1 << 13)).view(
        torch.float32)


def split_tf32(t, rounded: bool = True, small_rounded: bool = False):
    """(big, small) of f32 `t` as the kernel splits it, as the tensor core
    reads them: big is t rounded to TF32 (its low 13 bits cleared, ties
    away from zero; with `rounded` False, truncated, as the kernel splits
    x in a convolution), small the rest with its low 13 bits dropped (with
    `small_rounded`, rounded to TF32, as the transposed convolution splits
    both operands)."""
    mask = -(1 << 13)
    bits = t.contiguous().view(torch.int32)
    big = ((bits + (1 << 12) if rounded else bits) & mask).view(torch.float32)
    rest = t - big
    small = (_round_tf32(rest) if small_rounded
             else (rest.view(torch.int32) & mask).view(torch.float32))
    return big, small


def conv2d_tc_plain(x, weight, bias=None, passes: int = 3, padding=None,
                    round_parts: bool = False):
    """The kernel's arithmetic in plain PyTorch (f32, TF32 off): the sum
    of the products small*big', big*small' and big*big' of the split
    operands (each exact in f32; x's split truncated, the weights'
    rounded; with `round_parts`, as the transposed convolution splits
    them, both operands' big and small parts rounded), then the bias;
    `passes=1` keeps big*big' alone, a single TF32 pass. `padding` is
    k // 2 by default."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    pad = weight.shape[-1] // 2 if padding is None else padding
    xb, xs = split_tf32(x, rounded=round_parts, small_rounded=round_parts)
    wb, ws = split_tf32(weight, small_rounded=round_parts)
    y = F.conv2d(xb, wb, padding=pad)
    if passes == 3:
        y = F.conv2d(xs, wb, padding=pad) + F.conv2d(xb, ws, padding=pad) + y
    return y if bias is None else y + bias[:, None, None]


def conv_transpose2d_phases(x, weight, bias=None, joint=False, conv=None):
    """conv_transpose2d(x, weight, bias, stride=2, padding=2,
    output_padding=1) for a (C_in, C_out, 5, 5) weight as its four
    phases' stride-1 correlations, each by `conv(x, kernel, padding)`
    (F.conv2d by default): in the joint form one correlation with
    `joint_kernel` at padding 1, pixel-shuffled; else each phase's with
    its `phase_kernels` kernel on x padded by 1 - py (1 - px) above (left)
    and 1 below (right), at (2h + py, 2w + px)."""
    conv = conv or (lambda t, k, pad: F.conv2d(t, k, padding=pad))
    if joint:
        y = F.pixel_shuffle(conv(x, joint_kernel(weight), 1), 2)
    else:
        B, _, H, W = x.shape
        y = x.new_empty((B, weight.shape[1], 2 * H, 2 * W))
        for (py, px), k in zip(PHASES, phase_kernels(weight)):
            y[:, :, py::2, px::2] = conv(F.pad(x, (1 - px, 1, 1 - py, 1)),
                                         k, 0)
    return y if bias is None else y + bias[:, None, None]


def conv_transpose2d_tc_plain(x, weight, bias=None, joint=None,
                              passes: int = 3):
    """The kernel's transposed convolution in plain PyTorch: the phases
    (`conv_transpose2d_phases`, in `deconv_joint(C_out)`'s form by
    default) by `conv2d_tc_plain`'s arithmetic, every part rounded."""
    if joint is None:
        joint = deconv_joint(weight.shape[1])
    return conv_transpose2d_phases(
        x, weight, bias, joint,
        lambda t, k, pad: conv2d_tc_plain(t, k, passes=passes, padding=pad,
                                          round_parts=True))


def _declare(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.stf_conv_tc_configs.restype = ctypes.c_int
    lib.stf_conv_tc_configs.argtypes = []
    lib.stf_conv_tc.restype = ctypes.c_int
    lib.stf_conv_tc.argtypes = [vp, vp, vp, vp] + [i32] * 8 + [vp]
    lib.stf_conv_tc_deconv.restype = ctypes.c_int
    lib.stf_conv_tc_deconv.argtypes = [vp, vp, vp, vp] + [i32] * 8 + [vp]
    lib.stf_conv_tc_pack.restype = ctypes.c_int
    lib.stf_conv_tc_pack.argtypes = [vp, vp, i32, i32, i32, i32, vp]
    lib.stf_conv_tc_error.restype = ctypes.c_char_p
    lib.stf_conv_tc_error.argtypes = [ctypes.c_int]


_native.declare("convtc", _declare)
