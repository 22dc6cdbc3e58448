"""What `conv_kernel_pct.*` reads: the program's counters of Conv2d FLOPs
by route (`conv_kernel_flops`, `conv_library_flops` on each codec call's
record, a replayed graph's captured sums included), over the traced
window's calls of one phase (`program.records`).

None where the records lack the counters (a program without the 3xTF32
convolution kernel), do not match the window, or count no convolution;
the harness then leaves the metric out of the result's line."""

from codecbench.harness import program


def conv_kernel_pct(ctx, phase):
    """FLOPs of the phase's Conv2d calls that launched the kernel, % of
    the FLOPs of all its Conv2d calls."""
    recs = program.records(ctx, phase)
    if recs is None or not all(hasattr(r, "conv_kernel_flops") for r in recs):
        return None
    kernel = sum(r.conv_kernel_flops for r in recs)
    total = kernel + sum(r.conv_library_flops for r in recs)
    return 100.0 * kernel / total if total else None
