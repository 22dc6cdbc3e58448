"""The program's z_code spans in encode calls (z's host rANS), ms an image."""
from codecbench.harness import program


def read(ctx):
    return program.z_code_ms_per_image(ctx, "encode")
