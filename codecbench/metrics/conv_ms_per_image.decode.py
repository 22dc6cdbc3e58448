"""Device time of convolution kernels in decode calls, ms an image."""
from codecbench.harness import readers


def read(ctx):
    return readers.kind_ms_per_image(ctx, "decode", "convolution")
