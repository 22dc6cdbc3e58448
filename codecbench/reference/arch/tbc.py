"""TBC, the reference of configuration model "tbc": the fully transformer
codec `TransformerBasedCoding` of the STF codebase
(`compressai/models/tbc.py`), after Zhu, Yang, Cohen, "Transformer-based
Transform Coding" (ICLR 2022, SwinT-ChARM).

Every transform is a Swin stack. The analysis `layers` has merge-first
stages: a patch merging to widths 128/192/256/320 (raw RGB goes straight
into the first), then 2/2/6/2 blocks with 8x8 windows and 32 heads (head
widths 4, 6, 8, 10). The synthesis `syn_layers` mirrors it with
split-last stages down to 3 channels. The hyper analysis `h_a` has two
merge-first stages (320 -> 192 -> 192, depths 5/1, 4x4 windows, 32 heads
of width 6); `h_mean_s` and `h_scale_s` are its split-last mirrors back
to 320 channels. The latent is WACNN's: M = 320 in 10 slices, each
conditioned on up to 5, with the 5-convolution GELU slice stacks. Every
Swin stack takes and returns NCHW and runs NHWC inside.

Departures from `compressai/models/tbc.py`, none of which changes what the
codec computes:
  * its `patch_embed` and `end_conv` are built there but never called;
    they are not built here, so the state dict lacks their keys;
  * its stochastic depth (drop path) acts in training only: absent here;
  * a block pads its map to window multiples after its first LayerNorm
    and keeps its window and shift however small the map, as the shared
    `SwinBlock` does (the torch Swin shrinks the window to a smaller map
    instead); every map of a 512x768 image is a window multiple, so the
    two agree there.

Built from the shared `SwinBlock`, `PatchMerging(dim, out)` and
`PatchSplit(dim, out)` of `codecbench/reference/models.py`; the state
dict's names are `layers.i.downsample.*`, `layers.i.blocks.j.*`,
`syn_layers.*`, `h_a.*`, `h_mean_s.*` and `h_scale_s.*`.
"""

import torch
import torch.nn as nn

from codecbench.reference.models import (
    ChannelAR,
    EntropyBottleneck,
    PatchMerging,
    PatchSplit,
    SwinBlock,
)


def _blocks(dim, depth, heads, ws, mlp_ratio):
    return nn.ModuleList(
        SwinBlock(dim, heads, ws, 0 if i % 2 == 0 else ws // 2, mlp_ratio)
        for i in range(depth))


class MergeFirst(nn.Module):
    """2x down to `out` channels (`downsample`), then `depth` blocks."""

    def __init__(self, dim, out, depth, heads, ws, mlp_ratio):
        super().__init__()
        self.downsample = PatchMerging(dim, out)
        self.blocks = _blocks(out, depth, heads, ws, mlp_ratio)

    def forward(self, x):
        x = self.downsample(x)
        for b in self.blocks:
            x = b(x)
        return x


class SplitLast(nn.Module):
    """`depth` blocks, then 2x up to `out` channels (`downsample`, as the
    STF codebase names it)."""

    def __init__(self, dim, out, depth, heads, ws, mlp_ratio):
        super().__init__()
        self.blocks = _blocks(dim, depth, heads, ws, mlp_ratio)
        self.downsample = PatchSplit(dim, out)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return self.downsample(x)


class SwinStack(nn.ModuleList):
    """Stages called as one module on an NCHW map."""

    def __init__(self, cls, dims_in, dims_out, depths, heads, ws, mlp_ratio):
        super().__init__(cls(a, b, d, heads, ws, mlp_ratio)
                         for a, b, d in zip(dims_in, dims_out, depths))

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        for stage in self:
            x = stage(x)
        return x.permute(0, 3, 1, 2)


class TBC(ChannelAR):
    def __init__(self, channels=(128, 192, 256, 320, 192, 192),
                 depths=(2, 2, 6, 2), h_depths=(5, 1), num_heads=32,
                 h_num_heads=32, window_size=8, h_window_size=4,
                 num_slices=10, mlp_ratio=4.0, param_dtype=torch.float32):
        super().__init__()
        m_ch, h_ch = tuple(channels[:4]), tuple(channels[4:])
        self.M, self.N = m_ch[-1], h_ch[-1]
        self.num_slices = num_slices
        self.max_support_slices = num_slices // 2
        in_dims = (3,) + m_ch[:-1]
        self.layers = SwinStack(MergeFirst, in_dims, m_ch, depths, num_heads,
                                window_size, mlp_ratio)
        self.syn_layers = SwinStack(SplitLast, m_ch[::-1], in_dims[::-1],
                                    depths[::-1], num_heads, window_size,
                                    mlp_ratio)
        h_in = (self.M,) + h_ch[:-1]
        self.h_a = SwinStack(MergeFirst, h_in, h_ch, h_depths, h_num_heads,
                             h_window_size, mlp_ratio)
        self.h_mean_s = SwinStack(SplitLast, h_ch[::-1], h_in[::-1],
                                  h_depths[::-1], h_num_heads, h_window_size,
                                  mlp_ratio)
        self.h_scale_s = SwinStack(SplitLast, h_ch[::-1], h_in[::-1],
                                   h_depths[::-1], h_num_heads, h_window_size,
                                   mlp_ratio)
        self._slice_transforms(self.M)
        self.entropy_bottleneck = EntropyBottleneck(self.N)

    def analysis(self, x):
        return self.layers(x)

    def synthesis(self, y_hat):
        return self.syn_layers(y_hat)

    def analysis_modules(self):
        return [self.layers, self.h_a]


ARCHITECTURE = TBC
