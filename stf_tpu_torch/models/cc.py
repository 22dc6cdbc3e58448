"""CC, the channel-wise context hyperprior without window attention (port
of `stf_tpu/models/cc.py`).

Architecture and module names are the reference's
(`compressai/models/CC.py:23-104`), so state_dict keys are the reference
torch keys:
  g_a: 4x stride-2 5x5 conv + GDN (convs at even Sequential indices);
  g_s: the mirror, transposed convs + IGDN;
  h_a: 3x3 conv -> ReLU -> 5x5 s2 -> ReLU -> 5x5 s2 (M -> mid -> N, mid =
    256 for (192, 320));
  h_mean_s / h_scale_s: 5x5 s2 deconv -> ReLU -> 5x5 s2 deconv -> ReLU ->
    3x3 conv (N -> N -> mid -> M), keys .0, .2, .4;
  context: 10 slices, at most 5 as support, 3-stage ReLU slice stacks
    in -> 224 -> 128 -> out.
"""

import torch.nn as nn

from ..entropy import EntropyBottleneck
from ..layers import GDN, conv, conv3x3, deconv
from .base import ChannelARModel, conv_gelu_stack, make_slice_transforms


def hyper_mid(N: int, M: int) -> int:
    """The hyper stacks' middle width: (N + M) / 2 rounded to a multiple of
    32 (256 for (192, 320))."""
    return round((N + M) / 2 / 32) * 32


def cc_slice_transform(in_ch: int, out_ch: int):
    """3-stage ReLU stack in -> 224 -> 128 -> out (`CC.py:74-100`)."""
    return conv_gelu_stack((in_ch, 224, 128, out_ch), (1, 1, 1),
                           activation="relu")


def cc_analysis(N: int, M: int):
    return nn.Sequential(conv(3, N), GDN(N), conv(N, N), GDN(N), conv(N, N),
                         GDN(N), conv(N, M))


def cc_synthesis(N: int, M: int):
    return nn.Sequential(
        deconv(M, N), GDN(N, inverse=True), deconv(N, N),
        GDN(N, inverse=True), deconv(N, N), GDN(N, inverse=True),
        deconv(N, 3),
    )


class CC(ChannelARModel):
    """Channel-wise context codec ("cc" in the registry)."""

    def __init__(self, N: int = 192, M: int = 320, num_slices: int = 10,
                 max_support_slices: int = 5):
        super().__init__()
        self.N, self.M = N, M
        self.num_slices = num_slices
        self.max_support_slices = max_support_slices
        mid = hyper_mid(N, M)
        self.g_a = cc_analysis(N, M)
        self.g_s = cc_synthesis(N, M)
        self.h_a = conv_gelu_stack((M, M, mid, N), (1, 2, 2),
                                   kernel_sizes=(3, 5, 5), activation="relu")
        for name in ("h_mean_s", "h_scale_s"):
            setattr(self, name, nn.Sequential(
                deconv(N, N), nn.ReLU(), deconv(N, mid), nn.ReLU(),
                conv3x3(mid, M),
            ))
        (self.cc_mean_transforms, self.cc_scale_transforms,
         self.lrp_transforms) = make_slice_transforms(
            M, num_slices, max_support_slices, stack=cc_slice_transform
        )
        self.entropy_bottleneck = EntropyBottleneck(N)
