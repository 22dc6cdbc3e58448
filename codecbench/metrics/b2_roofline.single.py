"""Kernel B2 (lane rANS decode) in decode calls: its least time from the
calls' symbols and stream bytes over its device time, %."""
from codecbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "decode", "B2", ctx.b2_bound_ms)
