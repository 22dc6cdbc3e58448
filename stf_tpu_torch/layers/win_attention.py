"""Shifted-window multi-head attention blocks (port of
`stf_tpu/layers/win_attention.py`).

Module and parameter names are the reference torch ones
(`compressai/layers/win_attention.py`, `layers/layers.py:45-89`), so a
WACNN state_dict carries keys such as `g_a.4.conv_b.0.attn.qkv.weight`.
The blocks take NCHW maps like the reference; the attention itself runs on
the NHWC view: roll by (-ss, -ss), qkv projection, kernel B1 on the
(B, H, W, 3C) projection, output projection, roll back by (+ss, +ss).
"""

import functools

import numpy as np
import torch
import torch.nn as nn

from .attention_core import window_attention
from .conv import conv1x1, conv3x3, gelu


def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Static pairwise relative-position index table (wh*ww, wh*ww): the
    2-D offset (dh, dw) flattens as (dh + wh - 1) * (2*ww - 1) + dw + ww - 1
    (reference `win_attention.py:59-74`)."""
    coords = np.stack(
        np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    )  # (2, wh, ww)
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def shifted_window_region_labels(
    H: int, W: int, window_size: int, shift_size: int
) -> np.ndarray:
    """Per-token shift-region labels for SW-MSA, shape (nW, N) int32: two
    tokens of a window attend with a -100 penalty when their labels
    differ (the reference's pairwise mask, `win_attention.py:159-179`)."""
    img_mask = np.zeros((H, W), np.int32)
    slices = (
        slice(0, -window_size),
        slice(-window_size, -shift_size),
        slice(-shift_size, None),
    )
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[h, w] = cnt
            cnt += 1
    ws = window_size
    mw = img_mask.reshape(H // ws, ws, W // ws, ws)
    return mw.transpose(0, 2, 1, 3).reshape(-1, ws * ws)


@functools.cache
def region_labels(H: int, W: int, window_size: int, shift_size: int,
                  device) -> torch.Tensor:
    """`shifted_window_region_labels` as an int32 tensor on `device`, made
    once per (H, W, window, shift, device). A codec's first call of a
    shape runs eagerly before its CUDA-graph capture, so the capture finds
    every table made and copies nothing from the host. The cache is never
    trimmed: a captured graph reads its tables by address, and a replay
    runs no Python that could hold them, so a freed table would be
    overwritten under the graph. The tables are small and few per size.
    A table is made outside inference mode even when the codec asks for it
    inside: training reuses it, and autograd cannot save an inference
    tensor for the backward."""
    lab = shifted_window_region_labels(H, W, window_size, shift_size)
    with torch.inference_mode(False):
        return torch.from_numpy(lab).to(device)


class WindowAttention(nn.Module):
    """W-MSA over an NHWC map whose H/W are window multiples: x is
    (B, H, W, C), returned in the same shape. `labels` (optional) is the
    (nW, N) int32 tensor of `shifted_window_region_labels`."""

    def __init__(self, dim: int, window_size, num_heads: int,
                 qkv_bias: bool = True, qk_scale=None):
        super().__init__()
        self.dim = dim
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        wh, ww = self.window_size
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wh - 1) * (2 * ww - 1), num_heads)
        )
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(wh, ww).reshape(-1)),
            persistent=False,
        )
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def relative_bias(self) -> torch.Tensor:
        """(nh, N, N) bias gathered once from the table."""
        N = self.window_size[0] * self.window_size[1]
        bias = self.relative_position_bias_table[self.relative_position_index]
        return bias.reshape(N, N, self.num_heads).permute(2, 0, 1).contiguous()

    def forward(self, x, labels=None):
        wh, ww = self.window_size
        if wh != ww:
            raise ValueError("window_attention takes square windows")
        qkv = self.qkv(x)
        out = window_attention(qkv, self.relative_bias(), labels, wh, self.scale)
        return self.proj(out)


class WinBasedAttention(nn.Module):
    """(S)W-MSA residual block (`win_attention.py:118-207`) on NCHW maps
    whose H and W are multiples of window_size."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8,
                 shift_size: int = 0):
        super().__init__()
        if not 0 <= shift_size < window_size:
            raise ValueError("shift_size must be in [0, window_size)")
        self.window_size = window_size
        self.shift_size = shift_size
        self.attn = WindowAttention(dim, (window_size, window_size), num_heads)

    def forward(self, x):
        ss = self.shift_size
        x = x.permute(0, 2, 3, 1)  # NHWC view
        _, H, W, _ = x.shape
        shortcut = x
        labels = None
        if ss > 0:
            labels = region_labels(H, W, self.window_size, ss, x.device)
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
        x = self.attn(x, labels=labels)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        return (shortcut + x).permute(0, 3, 1, 2).contiguous()


class ResidualUnit(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with GELUs (`layers.py:52-71`)."""

    def __init__(self, N: int):
        super().__init__()
        self.conv = nn.Sequential(
            conv1x1(N, N // 2), nn.GELU(), conv3x3(N // 2, N // 2), nn.GELU(),
            conv1x1(N // 2, N),
        )

    def forward(self, x):
        return gelu(self.conv(x) + x)


class Win_noShift_Attention(nn.Module):
    """CNN-codec attention block (`layers.py:45-89`): trunk conv_a(x) gated
    by the sigmoid of an attention branch conv_b(x), plus identity."""

    def __init__(self, dim: int, num_heads: int = 8, window_size: int = 8,
                 shift_size: int = 0):
        super().__init__()
        self.conv_a = nn.Sequential(
            ResidualUnit(dim), ResidualUnit(dim), ResidualUnit(dim)
        )
        self.conv_b = nn.Sequential(
            WinBasedAttention(dim, num_heads, window_size, shift_size),
            ResidualUnit(dim), ResidualUnit(dim), ResidualUnit(dim),
            conv1x1(dim, dim),
        )

    def forward(self, x):
        return self.conv_a(x) * torch.sigmoid(self.conv_b(x)) + x
