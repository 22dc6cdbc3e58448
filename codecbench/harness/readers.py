"""What the per-layer metric files (`codecbench/metrics/<name>.py`) read:
each takes the traced window's `Context` and returns a number, or None
where the trace holds nothing to read (the harness then leaves the metric
out of the result's line)."""

from . import arith

# the codec's probe spans that are host work, by phase: the lane stream's
# assembly and z's host rANS on encode; z's host rANS, the stream's
# parse, the banks' packing and upload, and z's dequantisation on decode
HOST_SPANS = {
    "encode": ("entropy", "z_rans"),
    "decode": ("z_host_rans", "y_unpack", "banks_pack", "banks_upload", "z_decode"),
}


def host_ms_per_image(ctx, phase):
    return ctx.trace.span_us(phase, HOST_SPANS[phase]) / 1e3 / ctx.images[phase]


def lane_host_fallback_pct(ctx):
    return 100.0 * ctx.host_encoded / ctx.segments if ctx.segments else None


def launches_per_image(ctx, phase):
    n = ctx.trace.launch_count(phase)
    return n / ctx.images[phase] if n else None


def kind_ms(ctx, phase, kind):
    return sum((t1 - t0) / 1e3 for name, t0, t1, _ in ctx.trace.device_ops(phase)
               if arith.kernel_group(name) == kind)


def kind_ms_per_image(ctx, phase, kind):
    ms = kind_ms(ctx, phase, kind)
    return ms / ctx.images[phase] if ms else None


def roofline_pct(ctx, phase, kind, bound_ms):
    """Least time over device time of the kernel's launches in the phase."""
    ms = kind_ms(ctx, phase, kind)
    return 100.0 * bound_ms / ms if ms else None


def mfu_pct(ctx, phase):
    wall_s = ctx.trace.wall_us(phase) / 1e6
    return 100.0 * ctx.flop_s[phase] / wall_s if wall_s and ctx.flop_s[phase] else None


def device_idle_pct(ctx, phase):
    wall = ctx.trace.wall_us(phase)
    return 100.0 * (1.0 - ctx.trace.busy_us(phase) / wall) if wall else None
