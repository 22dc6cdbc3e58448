"""What the per-layer metrics of the program's own spans and counters
read: the records of the port's codec calls (`stf_tpu_torch.utils.tracing`,
kept while the traced window's profiler records), matched to the window's
calls.

Each reader returns None where the program keeps no such records (one
without that module) or where they do not match the window's calls one
for one; the harness then leaves the metric out of the result's line."""

from collections import defaultdict

# a record's span from its first start to its last end lies inside its
# call's profiler range; the two clocks may differ by this much
_CLOCK_SLACK = 1.01
_CLOCK_SLACK_US = 100.0


def records(ctx, phase):
    """The program's records of the traced window's `phase` calls, in
    order: the phase's last n, n = the window's calls of the phase (the
    profiler's warm-up request lies before them). None unless there are n,
    each no longer than its call's range in the trace, and their images sum
    to the window's."""
    try:
        from stf_tpu_torch.utils import tracing
    except ImportError:
        return None
    window = ctx.trace.calls.get(phase, [])
    got = [c for c in tracing.calls() if c.phase == phase]
    if not window or len(got) < len(window):
        return None
    got = got[len(got) - len(window):]
    for rec, (a, b) in zip(got, window):
        if not rec.spans:
            return None
        us = (max(s.t1 for s in rec.spans) - min(s.t0 for s in rec.spans)) / 1e3
        if us > (b - a) * _CLOCK_SLACK + _CLOCK_SLACK_US:
            return None
    if sum(rec.images for rec in got) != ctx.images[phase]:
        return None
    return got


def self_ns(rec, kind):
    """Nanoseconds of `rec`'s spans of `kind`, each less its child spans."""
    children = defaultdict(int)
    for s in rec.spans:
        if s.parent is not None:
            children[s.parent] += s.t1 - s.t0
    return sum(s.t1 - s.t0 - children[i] for i, s in enumerate(rec.spans)
               if s.kind == kind)


def host_self_ms_per_image(ctx, phase):
    recs = records(ctx, phase)
    if recs is None:
        return None
    return sum(self_ns(r, "host") for r in recs) / 1e6 / ctx.images[phase]


def z_code_ms_per_image(ctx, phase):
    """The calls' own z coding (a self-check's z decode, inside an encode
    call, is the decode's)."""
    recs = records(ctx, phase)
    if recs is None:
        return None
    return sum(s.t1 - s.t0 for r in recs for s in r.spans
               if s.name == "z_code" and s.phase == phase) / 1e6 / ctx.images[phase]


def lane_framing_pct(ctx):
    recs = records(ctx, "encode")
    if recs is None:
        return None
    stream = sum(r.y_bytes + r.z_bytes for r in recs)
    return 100.0 * sum(r.framing_bytes for r in recs) / stream if stream else None


def fused_miss_pct(ctx, phase):
    recs = records(ctx, phase)
    if recs is None:
        return None
    return 100.0 * sum(r.outcome != "replay" for r in recs) / len(recs)
