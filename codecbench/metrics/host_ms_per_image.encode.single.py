"""Host work of a encode call (the codec's host probe spans, synchronised), ms an image."""
from codecbench.harness import readers


def read(ctx):
    return readers.host_ms_per_image(ctx, "encode")
