"""Kernel launches and graph launches the host issued in decode calls, an image."""
from codecbench.harness import readers


def read(ctx):
    return readers.launches_per_image(ctx, "decode")
