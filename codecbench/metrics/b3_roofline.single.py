"""Kernel B3 (lane rANS encode) in encode calls: its least time from the
calls' symbols and stream bytes over its device time, %."""
from codecbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "encode", "B3", ctx.b3_bound_ms)
