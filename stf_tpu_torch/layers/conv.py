"""Convolution helpers (port of `stf_tpu/layers/conv.py`).

The port runs its transforms NCHW with the reference's own torch layers:
``nn.Conv2d`` with ``padding = k//2`` and ``nn.ConvTranspose2d`` with
``padding = k//2, output_padding = stride - 1`` (exact 2x upsampling), the
layout the JAX package emulates with explicit padding
(`compressai/models/utils.py:114-132`, `layers/layers.py:29-43`). Its
convolutions are `Conv2d`, an ``nn.Conv2d`` whose f32 stride-1 calls on
the card outside autograd launch the 3xTF32 kernel (`conv_core`), and
its transposed convolutions `ConvTranspose2d`, whose 5x5 stride-2 calls
there launch the same kernel's sub-pixel phases.
"""

import torch.nn as nn
import torch.nn.functional as F

from ..utils import tracing
from . import conv_core


def _kept_packing(layer, pack):
    """`pack(layer.weight)`, kept on the layer while the weight keeps its
    storage and version (an in-place update, a load or a move makes a new
    one). The packing holds the weight's old storage, so that no new
    weight can take its address."""
    w = layer.weight
    key = (w.device, w.data_ptr(), w._version)
    kept = getattr(layer, "_tc_packing", None)
    if kept is None or kept[0] != key:
        kept = (key, w.detach(), pack(w))
        layer._tc_packing = kept
    return kept[2]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (the same parameters and state_dict keys) whose
    forward launches the 3xTF32 kernel (`conv_core.conv2d_tc`) where
    `conv_core.routes` holds, and ``F.conv2d`` otherwise: CPU tensors,
    bf16, strided convolutions, every call under autograd. It keeps the
    kernel's packing of its weight (`_packed`: twice the weight's bytes,
    C_in padded to a multiple of 8). While a codec call records
    (`utils.tracing`), each call adds its FLOPs to the record under its
    route."""

    def _packed(self):
        """`conv_core.pack_weight(self.weight)`, kept (`_kept_packing`)."""
        return _kept_packing(self, conv_core.pack_weight)

    def launches(self, x) -> bool:
        """Whether `forward(x)` launches the kernel (`conv_core.routes`)."""
        return conv_core.routes(x, self.weight, self.bias, self.stride,
                                self.padding, self.dilation, self.groups,
                                self.padding_mode)

    def forward(self, x):
        w = self.weight
        kernel = self.launches(x)
        if kernel:
            y = conv_core.conv2d_tc(x.contiguous(), w, self.bias,
                                    packed=self._packed())
        else:
            y = super().forward(x)
        counter = tracing.flop_counter()
        if counter is not None:
            tracing.count_conv(counter, kernel,
                               2 * y.numel() * (w.numel() // w.shape[0]))
        return y


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` (the same parameters and state_dict keys)
    whose forward launches the 3xTF32 kernel's four sub-pixel phases
    (`conv_core.conv_transpose2d_tc`) where `conv_core.routes_transposed`
    holds (the 5x5 stride-2 exact 2x upsampler that `deconv` builds), and
    ``F.conv_transpose2d`` otherwise: CPU tensors, bf16, other geometries,
    an `output_size`, every call under autograd. It keeps the kernel's
    packing of its weight as `Conv2d` does. While a codec call records
    (`utils.tracing`), each call adds its FLOPs to the record under its
    route."""

    def _packed(self):
        """`conv_core.deconv_pack_weight(self.weight)`, kept
        (`_kept_packing`)."""
        return _kept_packing(self, conv_core.deconv_pack_weight)

    def launches(self, x) -> bool:
        """Whether `forward(x)` launches the kernel
        (`conv_core.routes_transposed`)."""
        return conv_core.routes_transposed(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding, self.dilation, self.groups,
            self.padding_mode)

    def forward(self, x, output_size=None):
        w = self.weight
        kernel = output_size is None and self.launches(x)
        if kernel:
            y = conv_core.conv_transpose2d_tc(x.contiguous(), w, self.bias,
                                              packed=self._packed())
        else:
            y = super().forward(x, output_size)
        counter = tracing.flop_counter()
        if counter is not None:
            # the products taken: taps x C_in x C_out an input pixel
            tracing.count_deconv(counter, kernel,
                                 2 * x.numel() * w[0].numel())
        return y


def conv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2):
    return Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                  padding=kernel_size // 2)


def deconv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2):
    return ConvTranspose2d(in_ch, out_ch, kernel_size, stride=stride,
                           padding=kernel_size // 2,
                           output_padding=stride - 1)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1):
    return Conv2d(in_ch, out_ch, 3, stride=stride, padding=1)


def conv1x1(in_ch: int, out_ch: int, stride: int = 1):
    return Conv2d(in_ch, out_ch, 1, stride=stride)


def subpel_conv3x3(in_ch: int, out_ch: int, r: int = 1):
    """3x3 conv + PixelShuffle upsampler (`layers/layers.py:34-38`)."""
    return nn.Sequential(
        Conv2d(in_ch, out_ch * r ** 2, 3, padding=1), nn.PixelShuffle(r)
    )


def gelu(x):
    """Exact (erf-based) GELU."""
    return F.gelu(x)
