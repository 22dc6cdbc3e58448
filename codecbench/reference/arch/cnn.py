"""WACNN, the reference of configuration model "cnn": Zou, Song, Zhang,
"The Devil Is in the Details: Window-based Attention for Image
Compression" (CVPR 2022), `compressai/models/cnn.py` of the STF codebase.

g_a = 4 stride-2 5x5 convs with GDN and two window-attention blocks (8x8
windows, 8 heads; 4x4, 8 heads), g_s the mirror with IGDN and transposed
convs; hyper transforms of 3x3 convs and GELU; 10 channel slices, each
conditioned on up to 5 decoded ones, with a latent residual prediction
0.5 tanh(.). Holds what only WACNN builds (the residual units and the
attention block); the shared layers are in `codecbench/reference/models.py`.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from codecbench.reference.models import (
    GDN,
    ChannelAR,
    EntropyBottleneck,
    WindowAttention,
    conv,
    conv1x1,
    conv3x3,
    conv_stack,
    deconv,
    hyper_synthesis,
)


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


ARCHITECTURE = WACNN
