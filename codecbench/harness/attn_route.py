"""What `b1_head_group_pct.*` reads: the program's counters of kernel B1's
FLOPs by design (`b1_head_group_flops`, `b1_window_flops` on each codec
call's record, a replayed graph's captured sums included), over the traced
window's calls of one phase (`program.records`).

None where the records lack the counters (a program that does not count
B1 by design), do not match the window, or count no B1 launch; the
harness then leaves the metric out of the result's line."""

from codecbench.harness import program


def b1_head_group_pct(ctx, phase):
    """FLOPs of the phase's B1 launches of the head-group design, % of the
    FLOPs of all its B1 launches."""
    recs = program.records(ctx, phase)
    if recs is None or not all(hasattr(r, "b1_head_group_flops") for r in recs):
        return None
    group = sum(r.b1_head_group_flops for r in recs)
    total = group + sum(r.b1_window_flops for r in recs)
    return 100.0 * group / total if total else None
