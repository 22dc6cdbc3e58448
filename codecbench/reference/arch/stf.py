"""STF, the reference of configuration model "stf": the symmetrical
transformer of Zou, Song, Zhang (CVPR 2022), `compressai/models/stf.py`
of the STF codebase.

Swin analysis (patch 2, embed 48, depths 2/2/6/2, heads 3/6/12/24, 4x4
windows, patch merging), the mirrored Swin synthesis with patch splits,
then a 5x5 conv, pixel shuffle and a 3x3 conv; M = 384, 12 slices, each
conditioned on up to 6. Holds what only STF builds (the patch embedding);
the Swin block, stage, merge and split are in
`codecbench/reference/models.py`.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from codecbench.reference.models import (
    ChannelAR,
    Conv,
    EntropyBottleneck,
    Stage,
    conv_stack,
    hyper_synthesis,
)


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


ARCHITECTURE = STF
