"""ConvTranspose2d FLOPs (2 x input pixels x C_in x C_out x 25) of the
window's decode calls that ran on the port's 3xTF32 kernel, % of all
their ConvTranspose2d FLOPs (the program's counters)."""
from codecbench.harness import deconv_route


def read(ctx):
    return deconv_route.deconv_kernel_pct(ctx, "decode")
