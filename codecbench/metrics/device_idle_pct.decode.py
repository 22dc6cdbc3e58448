"""Share of decode calls' wall time with no operation on the device, %."""
from codecbench.harness import readers


def read(ctx):
    return readers.device_idle_pct(ctx, "decode")
