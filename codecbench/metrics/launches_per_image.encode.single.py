"""Kernel launches and graph launches the host issued in encode calls, an image."""
from codecbench.harness import readers


def read(ctx):
    return readers.launches_per_image(ctx, "encode")
