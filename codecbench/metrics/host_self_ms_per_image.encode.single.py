"""Self time of the program's host spans in encode calls (stream assembly
and packing, rANS, staging; no wait on the card, no graph launch and no
probe), ms an image."""
from codecbench.harness import program


def read(ctx):
    return program.host_self_ms_per_image(ctx, "encode")
