"""Plain PyTorch WACNN and STF: the benchmark's reference of the coding
transforms.

Independent of the program under test: no kernel of its own, no CUDA
graph, no native library, nothing imported from the measured package.
Module and parameter names are the published models' torch names
(`compressai/models/cnn.py`, `compressai/models/stf.py` of the STF
codebase), so one state dict loads into the program's model and into
these. The forward follows the papers' equations at float32:

  * WACNN (Zou et al., CVPR 2022): g_a = 4 stride-2 5x5 convs with GDN
    and two window-attention blocks (8x8 windows, 8 heads; 4x4, 8 heads),
    g_s the mirror with IGDN and transposed convs; hyper transforms of
    3x3 convs and GELU; 10 channel slices, each conditioned on up to 5
    decoded ones, with a latent residual prediction 0.5 tanh(.).
  * STF (same paper): Swin analysis (patch 2, embed 48, depths 2/2/6/2,
    heads 3/6/12/24, 4x4 windows, patch merging), the mirrored Swin
    synthesis with patch splits, then a 5x5 conv, pixel shuffle and a 3x3
    conv; M = 384, 12 slices, each conditioned on up to 6.

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
"""

import math
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


# -- WACNN ------------------------------------------------------------------


class ResidualUnit(nn.Module):
    def __init__(self, n):
        super().__init__()
        self.conv = nn.Sequential(conv1x1(n, n // 2), nn.GELU(),
                                  conv3x3(n // 2, n // 2), nn.GELU(),
                                  conv1x1(n // 2, n))

    def forward(self, x):
        return F.gelu(self.conv(x) + x)


class WinBasedAttention(nn.Module):
    """Shifted-window attention with a residual, on an NCHW map."""

    def __init__(self, dim, heads, ws, shift):
        super().__init__()
        self.shift = shift
        self.attn = WindowAttention(dim, ws, heads)

    def forward(self, x):
        s = self.shift
        h = x.permute(0, 2, 3, 1)
        a = torch.roll(h, (-s, -s), (1, 2)) if s else h
        a = self.attn(a, s)
        a = torch.roll(a, (s, s), (1, 2)) if s else a
        return (h + a).permute(0, 3, 1, 2)


class AttentionBlock(nn.Module):
    """WACNN's attention block: conv_a(x) * sigmoid(conv_b(x)) + x."""

    def __init__(self, dim, heads, ws, shift):
        super().__init__()
        self.conv_a = nn.Sequential(*[ResidualUnit(dim) for _ in range(3)])
        self.conv_b = nn.Sequential(WinBasedAttention(dim, heads, ws, shift),
                                    *[ResidualUnit(dim) for _ in range(3)],
                                    conv1x1(dim, dim))

    def forward(self, x):
        return self.conv_a(x) * torch.sigmoid(self.conv_b(x)) + x


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
    """The coding steps both models share, on NCHW tensors."""

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


def _ramp(a, b, n=5):
    return tuple(round(a + (b - a) * i / (n - 1)) for i in range(n))


class WACNN(ChannelAR):
    def __init__(self, N=192, M=320, num_slices=10, max_support_slices=5,
                 param_dtype=torch.float32):
        super().__init__()
        self.N, self.M = N, M
        self.num_slices, self.max_support_slices = num_slices, max_support_slices
        gdn = lambda inverse=False: GDN(N, inverse, param_dtype)  # noqa: E731
        self.g_a = nn.Sequential(
            conv(3, N), gdn(), conv(N, N), gdn(),
            AttentionBlock(N, 8, 8, 4), conv(N, N), gdn(), conv(N, M),
            AttentionBlock(M, 8, 4, 2))
        self.g_s = nn.Sequential(
            AttentionBlock(M, 8, 4, 2), deconv(M, N), gdn(True),
            deconv(N, N), gdn(True), AttentionBlock(N, 8, 8, 4),
            deconv(N, N), gdn(True), deconv(N, 3))
        self.h_a = conv_stack((M,) + _ramp(M, N), (1, 1, 2, 1, 2))
        self.h_mean_s = hyper_synthesis((N,) + _ramp(N, M))
        self.h_scale_s = hyper_synthesis((N,) + _ramp(N, M))
        self._slice_transforms(M)
        self.entropy_bottleneck = EntropyBottleneck(N)

    def analysis(self, x):
        return self.g_a(x)

    def synthesis(self, y_hat):
        return self.g_s(y_hat)

    def analysis_modules(self):
        return [self.g_a, self.h_a]


# -- STF --------------------------------------------------------------------


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
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        _, H, W, _ = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class PatchSplit(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.reduction = Linear(dim, 2 * dim, bias=False)

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


class PatchEmbed(nn.Module):
    def __init__(self, patch, embed):
        super().__init__()
        self.patch = patch
        self.proj = Conv(3, embed, patch, stride=patch)
        self.norm = nn.LayerNorm(embed, eps=1e-5)

    def forward(self, x):
        p = self.patch
        H, W = x.shape[2:]
        if H % p or W % p:
            x = F.pad(x, (0, -W % p, 0, -H % p))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class STF(ChannelAR):
    def __init__(self, patch_size=2, embed_dim=48, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window_size=4, num_slices=12,
                 mlp_ratio=4.0, param_dtype=torch.float32):
        super().__init__()
        n = len(depths)
        self.M = embed_dim * 2 ** (n - 1)
        self.N = self.M // 2
        self.num_slices = num_slices
        self.max_support_slices = num_slices // 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.layers = nn.ModuleList(
            Stage(embed_dim * 2 ** i, depths[i], num_heads[i], window_size,
                  "merge" if i < n - 1 else None) for i in range(n))
        self.syn_layers = nn.ModuleList(
            Stage(embed_dim * 2 ** (n - 1 - i), depths[::-1][i],
                  num_heads[::-1][i], window_size,
                  "split" if i < n - 1 else None) for i in range(n))
        self.end_conv = nn.Sequential(
            Conv(embed_dim, embed_dim * patch_size ** 2, 5, padding=2),
            nn.PixelShuffle(patch_size), Conv(embed_dim, 3, 3, padding=1))
        M, N = self.M, self.N
        self.h_a = conv_stack((M, M, 336, 288, 240, N), (1, 1, 2, 1, 2))
        self.h_mean_s = hyper_synthesis((N, 240, 288, 336, 384, 384))
        self.h_scale_s = hyper_synthesis((N, 240, 288, 336, 384, 384))
        self._slice_transforms(384)
        self.entropy_bottleneck = EntropyBottleneck(N)

    def analysis(self, x):
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x)
        return x.permute(0, 3, 1, 2)

    def synthesis(self, y_hat):
        x = y_hat.permute(0, 2, 3, 1)
        for layer in self.syn_layers:
            x = layer(x)
        return self.end_conv(x.permute(0, 3, 1, 2))

    def analysis_modules(self):
        return [self.patch_embed, self.layers, self.h_a]


ARCHITECTURES = {"cnn": WACNN, "stf": STF}


def build(model: str, arch: dict, param_dtype=torch.float32,
          device=None) -> ChannelAR:
    """The reference model `model` ("cnn" or "stf") at the sizes `arch`,
    its parameters uninitialised, on `device`."""
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()}
    with torch.device(device or "cpu"):
        return ARCHITECTURES[model](param_dtype=param_dtype, **kw).eval()


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
