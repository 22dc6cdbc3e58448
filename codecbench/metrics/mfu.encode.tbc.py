"""TBC's transforms' FLOPs of encode calls at each dtype's peak over the
calls' wall time, %: the whole step's share of the card's peak."""
from codecbench.harness import readers


def read(ctx):
    return readers.mfu_pct(ctx, "encode")
