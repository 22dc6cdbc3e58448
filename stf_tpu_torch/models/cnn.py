"""WACNN — the CNN codec with window attention and channel-wise
autoregressive context (port of `stf_tpu/models/cnn.py`).

Architecture and module names are the reference's
(`compressai/models/cnn.py:23-130`), so state_dict keys are the reference
torch keys:
  g_a: 4x stride-2 5x5 conv + GDN with two Win_noShift_Attention blocks
  g_s: mirror with IGDN + transposed convs
  h_a / h_mean_s / h_scale_s: 3x3 conv stacks (GELU), subpel upsamplers
  num_slices latent slices; slice i conditions on the hyper latent plus up
  to max_support_slices decoded slices; lrp correction 0.5*tanh(.)
"""

import torch.nn as nn

from ..entropy import EntropyBottleneck
from ..layers import GDN, Win_noShift_Attention, conv, deconv
from .base import (
    ChannelARModel,
    conv_gelu_stack,
    hyper_synthesis,
    make_slice_transforms,
)


def _ramp(a: int, b: int, n: int = 5):
    """Arithmetic channel ramp a -> b with n entries (reference widths
    320,288,256,224,192 are exactly this for (M, N))."""
    return tuple(round(a + (b - a) * i / (n - 1)) for i in range(n))


class WACNN(ChannelARModel):
    """CNN-based codec ("cnn" in the registry)."""

    def __init__(self, N: int = 192, M: int = 320, num_slices: int = 10,
                 max_support_slices: int = 5):
        super().__init__()
        self.N, self.M = N, M
        self.num_slices = num_slices
        self.max_support_slices = max_support_slices
        self.g_a = nn.Sequential(
            conv(3, N), GDN(N), conv(N, N), GDN(N),
            Win_noShift_Attention(N, num_heads=8, window_size=8, shift_size=4),
            conv(N, N), GDN(N), conv(N, M),
            Win_noShift_Attention(M, num_heads=8, window_size=4, shift_size=2),
        )
        self.g_s = nn.Sequential(
            Win_noShift_Attention(M, num_heads=8, window_size=4, shift_size=2),
            deconv(M, N), GDN(N, inverse=True),
            deconv(N, N), GDN(N, inverse=True),
            Win_noShift_Attention(N, num_heads=8, window_size=8, shift_size=4),
            deconv(N, N), GDN(N, inverse=True),
            deconv(N, 3),
        )
        ramp = _ramp(M, N)
        self.h_a = conv_gelu_stack((M,) + ramp, (1, 1, 2, 1, 2))
        self.h_mean_s = hyper_synthesis((N,) + _ramp(N, M))
        self.h_scale_s = hyper_synthesis((N,) + _ramp(N, M))
        (self.cc_mean_transforms, self.cc_scale_transforms,
         self.lrp_transforms) = make_slice_transforms(
            M, num_slices, max_support_slices
        )
        self.entropy_bottleneck = EntropyBottleneck(N)
