"""decode calls whose fused path did not replay a cached graph (a capture,
an eager run, a fallback or a demotion), % of the calls."""
from codecbench.harness import program


def read(ctx):
    return program.fused_miss_pct(ctx, "decode")
