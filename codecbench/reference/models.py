"""The parts that the benchmark's plain PyTorch reference architectures
share; each architecture is a file of its own, `arch/<model>.py`, found
by the configuration's `model` (`build`).

Independent of the program under test: no kernel of its own, no CUDA
graph, no native library, nothing imported from the measured package.
Module and parameter names are the published models' torch names
(`compressai/models/*.py` of the STF codebase), so one state dict loads
into the program's model and into these. The forward follows the papers'
equations at float32. Here: the products (convolution, transposed
convolution, linear), GDN, window attention, the Swin block, stage,
patch merging and split, the hyper and slice convolution stacks, the
entropy bottleneck's parameters and `ChannelAR`, the channel-wise coding
steps every architecture inherits.

Window attention is written out: softmax(q k^T * hd^-0.5 + relative
position bias + shift penalty) v, with a -100 penalty between tokens of
different shift regions. As in the program, a Swin block pads its map to
window multiples after its first LayerNorm.

Precision: every product (convolution, linear, attention matmul) passes
its two inputs through the module's `rnd` (identity by default), so a
control can compute the same graph at a lower precision (`set_rounding`).
GDN's reparametrised beta and gamma are computed in `param_dtype`: a
configuration that serves its parameters in bfloat16 states that this
step runs in bfloat16.

An architecture file imports torch, this module and the standard library
(nothing of the program: `test_bench_reference.py` checks), subclasses
`ChannelAR`, takes `param_dtype` and its configuration's `arch` keys as
keyword arguments, and ends with `ARCHITECTURE = <its class>`.
"""

import importlib.util
import math
import os
import re
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class Conv(nn.Conv2d):
    rnd: Callable = staticmethod(identity)

    def forward(self, x):
        return self._conv_forward(self.rnd(x), self.rnd(self.weight), self.bias)


class Deconv(nn.ConvTranspose2d):
    rnd: Callable = staticmethod(identity)

    def forward(self, x):
        return F.conv_transpose2d(self.rnd(x), self.rnd(self.weight), self.bias,
                                  self.stride, self.padding,
                                  self.output_padding)


class Linear(nn.Linear):
    rnd: Callable = staticmethod(identity)

    def forward(self, x):
        return F.linear(self.rnd(x), self.rnd(self.weight), self.bias)


def conv(cin, cout, k=5, stride=2):
    return Conv(cin, cout, k, stride=stride, padding=k // 2)


def deconv(cin, cout, k=5, stride=2):
    return Deconv(cin, cout, k, stride=stride, padding=k // 2,
                  output_padding=stride - 1)


def conv3x3(cin, cout):
    return Conv(cin, cout, 3, padding=1)


def conv1x1(cin, cout):
    return Conv(cin, cout, 1)


def subpel3x3(cin, cout, r):
    return nn.Sequential(conv3x3(cin, cout * r * r), nn.PixelShuffle(r))


class GDN(nn.Module):
    """y = x / sqrt(beta + gamma . x^2) (inverse: times the root); beta and
    gamma are stored as sqrt(v + pedestal) and decoded as
    max(stored, sqrt(minimum + pedestal))^2 - pedestal (Balle et al.)."""

    PEDESTAL = (2 ** -18) ** 2
    rnd: Callable = staticmethod(identity)

    def __init__(self, channels, inverse=False, param_dtype=torch.float32):
        super().__init__()
        self.inverse = inverse
        self.param_dtype = param_dtype
        self.beta = nn.Parameter(torch.empty(channels))
        self.gamma = nn.Parameter(torch.empty(channels, channels))

    def _decode(self, stored, minimum):
        bound = (minimum + self.PEDESTAL) ** 0.5
        out = torch.clamp_min(stored.to(self.param_dtype), bound)
        return out * out - self.PEDESTAL

    def forward(self, x):
        beta = self._decode(self.beta, 1e-6).to(x.dtype)
        gamma = self._decode(self.gamma, 0.0).to(x.dtype)
        norm = F.conv2d(self.rnd(x * x), self.rnd(gamma[:, :, None, None]), beta)
        norm = torch.sqrt(norm) if self.inverse else torch.rsqrt(norm)
        return x * norm


def region_labels(H, W, ws, ss) -> np.ndarray:
    """(nW, ws*ws) shift-region label of every token of every window of an
    (H, W) map shifted by ss; windows row-major."""
    img = np.zeros((H, W), np.int64)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for w in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[h, w] = cnt
            cnt += 1
    return img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3).reshape(
        -1, ws * ws)


def relative_index(ws) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 relative-position table."""
    c = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    c = c.reshape(2, -1)
    rel = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


class WindowAttention(nn.Module):
    """Multi-head attention inside ws x ws windows of an NHWC map whose
    sides are window multiples (the map arrives already rolled)."""

    rnd: Callable = staticmethod(identity)
    # hook for the metric arithmetic: called with (module, qkv shape)
    observer: Optional[Callable] = None

    def __init__(self, dim, ws, heads):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws - 1) ** 2, heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, shift):
        B, H, W, C = x.shape
        ws, nh = self.ws, self.heads
        hd, N = C // nh, ws * ws
        qkv = self.qkv(x)
        if self.observer is not None:
            self.observer(self, tuple(qkv.shape), shift)
        t = qkv.reshape(B, H // ws, ws, W // ws, ws, 3, nh, hd)
        t = t.permute(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, nh, N, hd)
        q, k, v = t[0], t[1], t[2]
        idx = torch.from_numpy(relative_index(ws).reshape(-1)).to(x.device)
        bias = self.relative_position_bias_table[idx].reshape(N, N, nh)
        s = torch.matmul(self.rnd(q * hd ** -0.5), self.rnd(k.transpose(-2, -1)))
        s = s + bias.permute(2, 0, 1)
        if shift:
            lab = torch.from_numpy(region_labels(H, W, ws, shift)).to(x.device)
            pen = torch.where(lab[:, :, None] != lab[:, None, :], -100.0, 0.0)
            nW = lab.shape[0]
            s = (s.reshape(B, nW, nh, N, N) + pen[None, :, None]).reshape(
                -1, nh, N, N)
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(self.rnd(p), self.rnd(v))
        o = o.reshape(B, H // ws, W // ws, nh, ws, ws, hd)
        o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, H, W, C)
        return self.proj(o)


# -- convolution stacks, entropy bottleneck, the channel-wise walk ------------


def conv_stack(widths, strides):
    layers = []
    for i, s in enumerate(strides):
        layers.append(Conv(widths[i], widths[i + 1], 3, stride=s, padding=1))
        if i < len(strides) - 1:
            layers.append(nn.GELU())
    return nn.Sequential(*layers)


def hyper_synthesis(c):
    return nn.Sequential(conv3x3(c[0], c[1]), nn.GELU(), subpel3x3(c[1], c[2], 2),
                         nn.GELU(), conv3x3(c[2], c[3]), nn.GELU(),
                         subpel3x3(c[3], c[4], 2), nn.GELU(),
                         conv3x3(c[4], c[5]))


def slice_stack(cin, cout):
    return conv_stack((cin, 224, 176, 128, 64, cout), (1,) * 5)


class EntropyBottleneck(nn.Module):
    """The factorized prior's parameters; the coding check reads only
    its medians (quantiles[:, 0, 1])."""

    def __init__(self, channels, filters=(3, 3, 3, 3)):
        super().__init__()
        dims = (1,) + tuple(filters) + (1,)
        self.dims = dims
        for i in range(len(dims) - 1):
            self.register_parameter(
                f"_matrix{i}", nn.Parameter(torch.empty(channels, dims[i + 1], dims[i])))
            self.register_parameter(
                f"_bias{i}", nn.Parameter(torch.empty(channels, dims[i + 1], 1)))
            if i < len(dims) - 2:
                self.register_parameter(
                    f"_factor{i}", nn.Parameter(torch.empty(channels, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3))

    def medians(self):
        return self.quantiles[:, 0, 1]


class ChannelAR(nn.Module):
    """The coding steps every architecture shares, on NCHW tensors."""

    def split(self, y):
        w = -(-self.M // self.num_slices)
        bounds = [min(w * i, self.M) for i in range(self.num_slices + 1)]
        return [y[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]

    def support(self, decoded):
        k = self.max_support_slices
        return list(decoded) if k < 0 else list(decoded)[:k]

    def analyze(self, x):
        y = self.analysis(x)
        return y, self.h_a(y)

    def hyper(self, z_hat, hw):
        h, w = hw
        return (self.h_mean_s(z_hat)[:, :, :h, :w],
                self.h_scale_s(z_hat)[:, :, :h, :w])

    def slice_mu_scale(self, i, lm, ls, support):
        ms = torch.cat([lm] + list(support), 1)
        mu = self.cc_mean_transforms[i](ms)
        scale = self.cc_scale_transforms[i](torch.cat([ls] + list(support), 1))
        return mu, scale, ms

    def lrp(self, i, ms, y_hat_slice):
        return 0.5 * torch.tanh(self.lrp_transforms[i](torch.cat([ms, y_hat_slice], 1)))

    def synthesize(self, y_hat):
        return torch.clamp(self.synthesis(y_hat), 0.0, 1.0)

    def _slice_transforms(self, hyper_ch):
        w = -(-self.M // self.num_slices)
        widths = [min(w * (i + 1), self.M) - min(w * i, self.M)
                  for i in range(self.num_slices)]
        k = self.max_support_slices
        ctx = [hyper_ch + sum(widths[:i if k < 0 else min(i, k)])
               for i in range(self.num_slices)]
        self.cc_mean_transforms = nn.ModuleList(
            slice_stack(c, w) for c, w in zip(ctx, widths))
        self.cc_scale_transforms = nn.ModuleList(
            slice_stack(c, w) for c, w in zip(ctx, widths))
        self.lrp_transforms = nn.ModuleList(
            slice_stack(c + w, w) for c, w in zip(ctx, widths))

    def analysis_modules(self):
        """The modules an encoder's analysis runs (g_a and h_a)."""
        raise NotImplementedError


# -- Swin parts --------------------------------------------------------------


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, ws, shift, mlp_ratio=4.0):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, ws, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        _, H, W, _ = x.shape
        ws, s = self.ws, self.shift
        a = self.norm1(x)
        pb, pr = -H % ws, -W % ws
        if pb or pr:
            a = F.pad(a, (0, 0, 0, pr, 0, pb))
        a = torch.roll(a, (-s, -s), (1, 2)) if s else a
        a = self.attn(a, s)
        a = torch.roll(a, (s, s), (1, 2)) if s else a
        x = x + a[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2x down: each 2x2 neighbourhood gathered, LayerNorm(4 dim), then a
    Linear to `out` channels (2 dim by default, STF's)."""

    def __init__(self, dim, out=None):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim if out is None else out, bias=False)

    def forward(self, x):
        _, H, W, _ = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class PatchSplit(nn.Module):
    """2x up: LayerNorm(dim), a Linear to 4 `out` channels (dim / 2 by
    default, STF's), then depth-to-space in PixelShuffle's order."""

    def __init__(self, dim, out=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.reduction = Linear(dim, 2 * dim if out is None else 4 * out, bias=False)

    def forward(self, x):
        x = self.reduction(self.norm(x))
        B, H, W, C = x.shape
        c = C // 4
        x = x.reshape(B, H, W, c, 2, 2).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(B, 2 * H, 2 * W, c)


class Stage(nn.Module):
    def __init__(self, dim, depth, heads, ws, resample):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, ws, 0 if i % 2 == 0 else ws // 2)
            for i in range(depth))
        self.downsample = (None if resample is None
                           else {"merge": PatchMerging, "split": PatchSplit}[resample](dim))

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x if self.downsample is None else self.downsample(x)


# -- the architectures, one file each ------------------------------------------

ARCH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "arch")
MODEL_NAME = re.compile(r"[a-z0-9_]+")


def build(model: str, arch: dict, param_dtype=torch.float32,
          device=None) -> ChannelAR:
    """The reference model `model` at the sizes `arch`, its parameters
    uninitialised, on `device`: the `ARCHITECTURE` of `arch/<model>.py`,
    loaded by path."""
    if not isinstance(model, str) or not MODEL_NAME.fullmatch(model):
        raise ValueError(f"model name {model!r}: expected [a-z0-9_]+")
    path = os.path.join(ARCH_DIR, model + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no reference architecture for model {model!r}: "
                       f"expected the file {path}")
    spec = importlib.util.spec_from_file_location("codecbench_arch_" + model, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()}
    with torch.device(device or "cpu"):
        return mod.ARCHITECTURE(param_dtype=param_dtype, **kw).eval()


def set_rounding(module: nn.Module, fn: Callable) -> None:
    """Route both inputs of every product in `module` through `fn`."""
    for m in module.modules():
        if isinstance(m, (Conv, Deconv, Linear, GDN, WindowAttention)):
            m.rnd = fn


def scale_table() -> torch.Tensor:
    """The 64 log-spaced Gaussian scales from 0.11 to 256 (f32)."""
    return torch.from_numpy(np.exp(np.linspace(
        math.log(0.11), math.log(256), 64)).astype(np.float32))


def attention_modules(module: nn.Module) -> Sequence[WindowAttention]:
    return [m for m in module.modules() if isinstance(m, WindowAttention)]
