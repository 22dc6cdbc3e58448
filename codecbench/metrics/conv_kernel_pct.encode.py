"""Conv2d FLOPs (2 M N K) of the window's encode calls that ran on the
port's 3xTF32 convolution kernel, % of all their Conv2d FLOPs (the
program's counters)."""
from codecbench.harness import conv_route


def read(ctx):
    return conv_route.conv_kernel_pct(ctx, "encode")
