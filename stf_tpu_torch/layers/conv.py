"""Convolution helpers (port of `stf_tpu/layers/conv.py`).

The port runs its transforms NCHW with the reference's own torch layers:
``nn.Conv2d`` with ``padding = k//2`` and ``nn.ConvTranspose2d`` with
``padding = k//2, output_padding = stride - 1`` (exact 2x upsampling), the
layout the JAX package emulates with explicit padding
(`compressai/models/utils.py:114-132`, `layers/layers.py:29-43`).
"""

import torch.nn as nn
import torch.nn.functional as F


def conv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2):
    return nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                     padding=kernel_size // 2)


def deconv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2):
    return nn.ConvTranspose2d(in_ch, out_ch, kernel_size, stride=stride,
                              padding=kernel_size // 2,
                              output_padding=stride - 1)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1):
    return nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1)


def conv1x1(in_ch: int, out_ch: int, stride: int = 1):
    return nn.Conv2d(in_ch, out_ch, 1, stride=stride)


def subpel_conv3x3(in_ch: int, out_ch: int, r: int = 1):
    """3x3 conv + PixelShuffle upsampler (`layers/layers.py:34-38`)."""
    return nn.Sequential(
        nn.Conv2d(in_ch, out_ch * r ** 2, 3, padding=1), nn.PixelShuffle(r)
    )


def gelu(x):
    """Exact (erf-based) GELU."""
    return F.gelu(x)
