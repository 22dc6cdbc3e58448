"""TBC, the fully transformer-based codec (port of `stf_tpu/models/tbc.py`).

Architecture and module names are the reference's
(`compressai/models/tbc.py:388-702`), so state_dict keys are the reference
torch keys:
  analysis `layers`: raw RGB pixels enter the first stage directly; each
    stage PatchMerges first (2x down), then runs its Swin blocks: widths
    128/192/256/320 over depths 2/2/6/2, window 8, 32 heads (head widths
    4, 6, 8, 10);
  hyper `h_a`: two more merge-first stages (depths 5/1, window 4, 32
    heads) to z of 192 channels at 1/64; `h_mean_s` / `h_scale_s`:
    split-last stages back to 320 channels at 1/16 (head width 6);
  synthesis `syn_layers`: split-last stages back to RGB, ending at the
    last PatchSplit (the reference's `end_conv` and `patch_embed` are
    never called and have no counterpart here);
  context: `num_slices` slices of ceil(M / num_slices) channels, the
    remainder on the last, WACNN's 5-conv GELU slice stacks.
Every stack takes and returns NCHW like every ChannelARModel; the Swin
stages run on NHWC maps inside.
"""

from typing import Sequence

import numpy as np
import torch.nn as nn

from ..entropy import EntropyBottleneck
from ..layers.swin import MergeFirstLayer, SplitLastLayer
from .base import ChannelARModel, make_slice_transforms


class SwinStack(nn.ModuleList):
    """A list of merge-first or split-last Swin stages called as one
    module: NCHW in, NHWC through the stages, NCHW out. Stage i is
    `<name>.i` in the state_dict."""

    def __init__(self, dims_in: Sequence[int], dims_out: Sequence[int],
                 depths: Sequence[int], num_heads: int, window_size: int,
                 mlp_ratio: float, drop_path: Sequence[float], kind: str):
        cls = {"merge": MergeFirstLayer, "split": SplitLastLayer}[kind]
        stages, start = [], 0
        for di, do, d in zip(dims_in, dims_out, depths):
            stages.append(cls(di, do, d, num_heads, window_size, mlp_ratio,
                              drop_path[start:start + d]))
            start += d
        super().__init__(stages)

    def forward(self, x, sampler=None):
        x = x.permute(0, 2, 3, 1)
        for stage in self:
            x = stage(x, sampler)
        return x.permute(0, 3, 1, 2).contiguous()


class TransformerBasedCoding(ChannelARModel):
    """Fully transformer codec ("tbc" in the registry). `embed_dim` is
    kept for the reference's signature; the reference's patch embedding
    that would use it is never called."""

    def __init__(self, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 h_depths: Sequence[int] = (5, 1), num_heads: int = 32,
                 h_num_heads: int = 32,
                 channels: Sequence[int] = (128, 192, 256, 320, 192, 192),
                 window_size: int = 8, h_window_size: int = 4,
                 num_slices: int = 10, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.2):
        super().__init__()
        depths, h_depths = tuple(depths), tuple(h_depths)
        m_ch, h_ch = tuple(channels[:4]), tuple(channels[4:])
        self.M, self.N = m_ch[-1], h_ch[-1]
        self.num_slices = num_slices
        self.max_support_slices = num_slices // 2
        self.analysis_downsample = 2 ** len(depths)
        self.hyper_upsample = 2 ** len(h_depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        in_dims = (3,) + m_ch[:-1]
        self.layers = SwinStack(in_dims, m_ch, depths, num_heads,
                                window_size, mlp_ratio, dpr, "merge")
        self.syn_layers = SwinStack(m_ch[::-1], in_dims[::-1], depths[::-1],
                                    num_heads, window_size, mlp_ratio, dpr,
                                    "split")
        h_in = (m_ch[-1],) + h_ch[:-1]
        h_dpr = dpr[:sum(h_depths)]
        self.h_a = SwinStack(h_in, h_ch, h_depths, h_num_heads,
                             h_window_size, mlp_ratio, h_dpr, "merge")
        for name in ("h_mean_s", "h_scale_s"):
            setattr(self, name, SwinStack(
                h_ch[::-1], h_in[::-1], h_depths[::-1], h_num_heads,
                h_window_size, mlp_ratio, h_dpr, "split",
            ))
        (self.cc_mean_transforms, self.cc_scale_transforms,
         self.lrp_transforms) = make_slice_transforms(
            self.M, num_slices, self.max_support_slices
        )
        self.entropy_bottleneck = EntropyBottleneck(self.N)

    def analysis(self, x, sampler=None):
        """NCHW image -> NCHW y."""
        return self.layers(x, sampler)

    def synthesis(self, y_hat, sampler=None):
        """NCHW y_hat -> NCHW x_hat (unclipped)."""
        return self.syn_layers(y_hat, sampler)
