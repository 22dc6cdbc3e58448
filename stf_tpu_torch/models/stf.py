"""SymmetricalTransFormer (STF), the Swin-Transformer codec (port of
`stf_tpu/models/stf.py`).

Architecture and module names are the reference's
(`compressai/models/stf.py:384-788`), so state_dict keys are the reference
torch keys:
  analysis: patch_embed (patch 2, embed 48, LN) -> 4 Swin stages `layers`
    with depths (2,2,6,2), heads (3,6,12,24), window 4, PatchMerging after
    the first three -> y with M = 8 * embed = 384 channels at 1/16 size
  synthesis: the mirror, `syn_layers` with PatchSplit, then end_conv
    (5x5 conv -> PixelShuffle(2) -> 3x3 conv to RGB)
  hyper: h_a M -> M -> 336 -> 288 (s2) -> 240 -> N = M/2 (s2); h_mean_s and
    h_scale_s N -> 240 -> 288 (subpel) -> 336 -> 384 (subpel) -> 384
  context: 12 slices, at most 6 of them as support, WACNN's slice stacks
`analysis` and `synthesis` take and return NCHW like every ChannelARModel;
the Swin stages run on NHWC maps inside. Stochastic depth: drop-path rates
spaced by linspace from 0 to `drop_path_rate` over the analysis blocks
(`stf.py:62,71` of the JAX package), the same list for the synthesis's
blocks; in training mode each block draws its masks from the sampler
`analysis` and `synthesis` are given. Built with `is_teacher`, the
forward also returns the NHWC latent "y" (`stf.py:63` of the JAX package),
the target of DYSTF's distillation (`training/dytrain.py`).
"""

from typing import Sequence

import numpy as np
import torch.nn as nn

from ..entropy import EntropyBottleneck
from ..layers import BasicLayer, PatchEmbed
from .base import (
    ChannelARModel,
    conv_gelu_stack,
    hyper_synthesis,
    make_slice_transforms,
)

# the reference's fixed hyper widths (`stf.py:476-509`)
HYPER_ANALYSIS = (336, 288, 240)
HYPER_SYNTHESIS = (240, 288, 336, 384, 384)


class SymmetricalTransFormer(ChannelARModel):
    """Swin-Transformer codec ("stf" in the registry)."""

    def __init__(self, patch_size: int = 2, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 4, num_slices: int = 12,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.2,
                 is_teacher: bool = False):
        super().__init__()
        self.is_teacher = is_teacher
        n = len(depths)
        self.M = embed_dim * 2 ** (n - 1)
        self.N = self.M // 2
        self.num_slices = num_slices
        self.max_support_slices = num_slices // 2
        self.analysis_downsample = patch_size * 2 ** (n - 1)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()

        def stages(dims, stage_depths, heads, resample):
            out, start = nn.ModuleList(), 0
            for i, depth in enumerate(stage_depths):
                out.append(BasicLayer(
                    dim=dims[i], depth=depth, num_heads=heads[i],
                    window_size=window_size, mlp_ratio=mlp_ratio,
                    drop_path=dpr[start:start + depth],
                    resample=resample if i < n - 1 else None,
                ))
                start += depth
            return out

        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.layers = stages([embed_dim * 2 ** i for i in range(n)],
                             list(depths), list(num_heads), "merge")
        self.syn_layers = stages(
            [embed_dim * 2 ** (n - 1 - i) for i in range(n)],
            list(depths)[::-1], list(num_heads)[::-1], "split",
        )
        self.end_conv = nn.Sequential(
            nn.Conv2d(embed_dim, embed_dim * patch_size ** 2, 5, padding=2),
            nn.PixelShuffle(patch_size),
            nn.Conv2d(embed_dim, 3, 3, padding=1),
        )
        M, N = self.M, self.N
        self.h_a = conv_gelu_stack((M, M) + HYPER_ANALYSIS + (N,),
                                   (1, 1, 2, 1, 2))
        self.h_mean_s = hyper_synthesis((N,) + HYPER_SYNTHESIS)
        self.h_scale_s = hyper_synthesis((N,) + HYPER_SYNTHESIS)
        (self.cc_mean_transforms, self.cc_scale_transforms,
         self.lrp_transforms) = make_slice_transforms(
            M, num_slices, self.max_support_slices,
            hyper_ch=HYPER_SYNTHESIS[-1],
        )
        self.entropy_bottleneck = EntropyBottleneck(N)

    def analysis(self, x, sampler=None):
        """NCHW image -> NCHW y."""
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x, sampler)
        return x.permute(0, 3, 1, 2).contiguous()

    def synthesis(self, y_hat, sampler=None):
        """NCHW y_hat -> NCHW x_hat (unclipped)."""
        x = y_hat.permute(0, 2, 3, 1).contiguous()
        for layer in self.syn_layers:
            x = layer(x, sampler)
        return self.end_conv(x.permute(0, 3, 1, 2).contiguous())
