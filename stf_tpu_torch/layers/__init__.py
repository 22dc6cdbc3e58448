from .attention_core import window_attention, window_attention_plain
from .conv import conv, conv1x1, conv3x3, deconv, gelu, subpel_conv3x3
from .gdn import GDN
from .win_attention import (
    ResidualUnit,
    WinBasedAttention,
    WindowAttention,
    Win_noShift_Attention,
    relative_position_index,
    shifted_window_region_labels,
)

__all__ = [
    "GDN",
    "ResidualUnit",
    "WinBasedAttention",
    "WindowAttention",
    "Win_noShift_Attention",
    "conv",
    "conv1x1",
    "conv3x3",
    "deconv",
    "gelu",
    "relative_position_index",
    "shifted_window_region_labels",
    "subpel_conv3x3",
    "window_attention",
    "window_attention_plain",
]
