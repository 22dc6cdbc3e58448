from .attention_core import window_attention, window_attention_plain
from .conv import Conv2d, conv, conv1x1, conv3x3, deconv, gelu, subpel_conv3x3
from .gdn import GDN
from .swin import (
    BasicLayer,
    DropPath,
    MergeFirstLayer,
    Mlp,
    PatchEmbed,
    PatchMerging,
    PatchSplit,
    SplitLastLayer,
    SwinTransformerBlock,
    pixel_shuffle_nhwc,
)
from .win_attention import (
    ResidualUnit,
    WinBasedAttention,
    WindowAttention,
    Win_noShift_Attention,
    region_labels,
    relative_position_index,
    shifted_window_region_labels,
)

__all__ = [
    "BasicLayer",
    "Conv2d",
    "DropPath",
    "GDN",
    "MergeFirstLayer",
    "Mlp",
    "PatchEmbed",
    "PatchMerging",
    "PatchSplit",
    "ResidualUnit",
    "SplitLastLayer",
    "SwinTransformerBlock",
    "WinBasedAttention",
    "WindowAttention",
    "Win_noShift_Attention",
    "conv",
    "conv1x1",
    "conv3x3",
    "deconv",
    "gelu",
    "pixel_shuffle_nhwc",
    "region_labels",
    "relative_position_index",
    "shifted_window_region_labels",
    "subpel_conv3x3",
    "window_attention",
    "window_attention_plain",
]
