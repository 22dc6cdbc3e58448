"""Kernel B1 (window attention) in decode calls: its least time from its
calls' shapes over its device time, %."""
from codecbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "decode", "B1", ctx.b1_bound_ms["decode"])
