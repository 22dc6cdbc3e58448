"""What `deconv_kernel_pct.*` reads: the program's counters of
ConvTranspose2d FLOPs by route (`deconv_kernel_flops`,
`deconv_library_flops` on each codec call's record, a replayed graph's
captured sums included), over the traced window's calls of one phase
(`program.records`).

None where the records lack the counters (a program whose transposed
convolutions all take the library), do not match the window, or count no
transposed convolution; the harness then leaves the metric out of the
result's line."""

from codecbench.harness import program


def deconv_kernel_pct(ctx, phase):
    """FLOPs of the phase's ConvTranspose2d calls that launched the 3xTF32
    kernel's sub-pixel phases, % of the FLOPs of all its ConvTranspose2d
    calls."""
    recs = program.records(ctx, phase)
    if recs is None or not all(hasattr(r, "deconv_kernel_flops")
                               for r in recs):
        return None
    kernel = sum(r.deconv_kernel_flops for r in recs)
    total = kernel + sum(r.deconv_library_flops for r in recs)
    return 100.0 * kernel / total if total else None
