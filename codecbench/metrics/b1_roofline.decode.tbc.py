"""Kernel B1 (window attention) in TBC's decode calls: its least time from its
calls' shapes over its device time, %. Mostly the head-group design at
8x8 windows; the hyper transforms' 4x4 window-head launches are a few %
of B1's device time here. The least time counts bytes and 4 N C
operations a token, not the N^2 exponentials a (window, head), so at
TBC's head widths it reads low, never high."""
from codecbench.harness import readers


def read(ctx):
    return readers.roofline_pct(ctx, "decode", "B1", ctx.b1_bound_ms["decode"])
