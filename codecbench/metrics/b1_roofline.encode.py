"""Kernel B1 (window attention) in encode calls: its least time from its
calls' shapes over its device time, %."""
from codecbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "encode", "B1", ctx.b1_bound_ms["encode"])
