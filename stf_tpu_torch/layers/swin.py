"""Swin-Transformer building blocks on NHWC maps (port of
`stf_tpu/layers/swin.py`).

Module and parameter names are the reference torch ones
(`compressai/models/stf.py:24-381`), so an STF state_dict carries keys such
as `layers.0.blocks.1.attn.qkv.weight` and `syn_layers.0.downsample.norm.bias`
(the reference calls PatchSplit's attribute `downsample` too). Maps stay
(B, H, W, C) from stage to stage, as in the JAX package; the attention core
is kernel B1 (`WindowAttention`). PatchEmbed is the one boundary: it takes
the NCHW image its strided convolution reads and returns NHWC.

As in the JAX package, and unlike the reference torch Swin, a block pads
its map up to window multiples after `norm1` and keeps its window and shift
however small the map: the padded tokens pass the qkv projection (its bias
included) and take part in the attention, and the shift-region labels are
those of the padded size. `MergeFirstLayer` and `SplitLastLayer` are
TBC's stages (`tbc.py:265-351` of the reference): a PatchMerging first,
or a PatchSplit last, at the widths the stage is given.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .conv import Conv2d
from .win_attention import WindowAttention, region_labels


def pixel_shuffle_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space on an NHWC map in torch PixelShuffle's channel order:
    channel c*r*r + i*r + j goes to offset (i, j) of output channel c."""
    B, H, W, C = x.shape
    c = C // (r * r)
    x = x.reshape(B, H, W, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H * r, W * r, c)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (`stf.py:24-40`)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class DropPath(nn.Module):
    """Per-sample stochastic depth on a residual branch (`swin.py:43-55`
    of the JAX package): in training mode with a nonzero rate, each
    sample's branch is kept with probability keep = 1 - rate and scaled
    by 1/keep, its Bernoulli(keep) draw of shape (B, 1, 1, 1) taken from
    `sampler`; the identity in eval mode. The draws come only from an
    explicit sampler (the trainer's), so training mode without one
    raises rather than draw from torch's global generator."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, sampler=None):
        if not (self.training and self.rate > 0.0):
            return x
        if sampler is None:
            raise NotImplementedError(
                "stochastic depth in training draws from an explicit "
                "sampler: pass one (the trainer does) or call model.eval()"
            )
        keep = 1.0 - self.rate
        mask = sampler.bernoulli(keep, (x.shape[0],) + (1,) * (x.dim() - 1), x)
        return torch.where(mask, x / keep, torch.zeros_like(x))


class SwinTransformerBlock(nn.Module):
    """norm1 -> pad to window multiples -> roll (-ss, -ss) -> W-MSA (kernel
    B1) -> roll back -> crop -> residual; norm2 -> mlp -> residual
    (`stf.py:124-199`), on an NHWC map."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 4,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        if not 0 <= shift_size < window_size:
            raise ValueError("shift_size must be in [0, window_size)")
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, (window_size, window_size), num_heads)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def attend(self, x):
        """The attention branch on an NHWC map: norm1, pad, roll, W-MSA,
        roll back, crop (no residual)."""
        _, H, W, _ = x.shape
        ws, ss = self.window_size, self.shift_size
        x = self.norm1(x)
        pad_b, pad_r = -H % ws, -W % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        labels = None
        if ss:
            labels = region_labels(H + pad_b, W + pad_r, ws, ss, x.device)
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
        x = self.attn(x, labels=labels)
        if ss:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :H, :W, :]
        return x

    def forward(self, x, sampler=None):
        x = x + self.drop_path(self.attend(x), sampler)
        return x + self.drop_path(self.mlp(self.norm2(x)), sampler)


class PatchMerging(nn.Module):
    """2x down: pad odd sizes, gather each 2x2 neighbourhood in the order
    (even,even), (odd,even), (even,odd), (odd,odd), LN(4C), then a Linear
    to `out_features` (2C by default) with no bias (`stf.py:202-235`; the
    width TBC's stages choose, `tbc.py:203-237`)."""

    def __init__(self, dim: int, out_features: Optional[int] = None):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, out_features or 2 * dim,
                                   bias=False)

    def forward(self, x):
        _, H, W, _ = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchSplit(nn.Module):
    """2x up: LN, a Linear to 4 * `out_features` (C // 2 by default) with
    no bias, then depth-to-space in PixelShuffle's channel order
    (`stf.py:238-260`; TBC's widths, `tbc.py:240-263`)."""

    def __init__(self, dim: int, out_features: Optional[int] = None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.reduction = nn.Linear(dim, 4 * (out_features or dim // 2),
                                   bias=False)

    def forward(self, x):
        return pixel_shuffle_nhwc(self.reduction(self.norm(x)), 2)


class PatchEmbed(nn.Module):
    """Patch embedding (`stf.py:350-381`): pad the NCHW RGB image to a
    patch multiple, a conv with kernel = stride = patch and no padding,
    then LN; returns the NHWC map."""

    def __init__(self, patch_size: int = 2, embed_dim: int = 48):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        p = self.patch_size
        H, W = x.shape[2:]
        if H % p or W % p:
            x = F.pad(x, (0, -W % p, 0, -H % p))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


def _blocks(dim: int, depth: int, num_heads: int, window_size: int,
            mlp_ratio: float, drop_path: Sequence[float]) -> nn.ModuleList:
    """`depth` Swin blocks, shift 0 and window_size // 2 alternating, block
    i at drop-path rate drop_path[i] (0 past its end)."""
    return nn.ModuleList(
        SwinTransformerBlock(
            dim, num_heads, window_size,
            shift_size=0 if i % 2 == 0 else window_size // 2,
            mlp_ratio=mlp_ratio,
            drop_path=drop_path[i] if i < len(drop_path) else 0.0,
        )
        for i in range(depth)
    )


class MergeFirstLayer(nn.Module):
    """TBC's analysis stage (`swin.py:174-201` of the JAX package): a
    PatchMerging dim_in -> dim_out (2x down) named `downsample`, then
    `depth` Swin blocks at dim_out."""

    def __init__(self, dim_in: int, dim_out: int, depth: int,
                 num_heads: int, window_size: int = 8,
                 mlp_ratio: float = 4.0, drop_path: Sequence[float] = ()):
        super().__init__()
        self.downsample = PatchMerging(dim_in, dim_out)
        self.blocks = _blocks(dim_out, depth, num_heads, window_size,
                              mlp_ratio, drop_path)

    def forward(self, x, sampler=None):
        x = self.downsample(x)
        for block in self.blocks:
            x = block(x, sampler)
        return x


class SplitLastLayer(nn.Module):
    """TBC's synthesis stage (`swin.py:204-231` of the JAX package):
    `depth` Swin blocks at dim, then a PatchSplit dim -> dim_out (2x up),
    named `downsample` as the reference names it."""

    def __init__(self, dim: int, dim_out: int, depth: int, num_heads: int,
                 window_size: int = 8, mlp_ratio: float = 4.0,
                 drop_path: Sequence[float] = ()):
        super().__init__()
        self.blocks = _blocks(dim, depth, num_heads, window_size, mlp_ratio,
                              drop_path)
        self.downsample = PatchSplit(dim, dim_out)

    def forward(self, x, sampler=None):
        for block in self.blocks:
            x = block(x, sampler)
        return self.downsample(x)


class BasicLayer(nn.Module):
    """One Swin stage (`stf.py:262-347`): `depth` blocks, shift 0 and
    window_size // 2 alternating, then `downsample`: PatchMerging for
    resample="merge" (analysis), PatchSplit for "split" (synthesis), or
    none. `sampler` feeds the blocks' DropPath in training."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 window_size: int = 4, mlp_ratio: float = 4.0,
                 drop_path: Sequence[float] = (),
                 resample: Optional[str] = None):
        super().__init__()
        self.blocks = _blocks(dim, depth, num_heads, window_size, mlp_ratio,
                              drop_path)
        resamplers = {"merge": PatchMerging, "split": PatchSplit}
        if resample is not None and resample not in resamplers:
            raise ValueError(f"resample is 'merge', 'split' or None, not "
                             f"{resample!r}")
        self.downsample = resamplers[resample](dim) if resample else None

    def forward(self, x, sampler=None):
        for block in self.blocks:
            x = block(x, sampler)
        return x if self.downsample is None else self.downsample(x)
