"""Lane segments whose escapes overflowed kernel B3's side channel and
that the host encoder coded instead, % of the segments coded."""
from codecbench.harness import readers


def read(ctx):
    return readers.lane_host_fallback_pct(ctx)
