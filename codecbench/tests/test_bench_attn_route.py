"""The readers of `b1_head_group_pct.*` (`harness/attn_route.py`) on
synthetic records of the program's codec calls: the share of kernel B1's
FLOPs that ran the head-group design, a replayed graph's captured sums
included, and nothing read from records without the counters."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from codecbench.harness import cell as harness
from codecbench.harness import program
from stf_tpu_torch.utils import tracing

NAMES = ("b1_head_group_pct.encode", "b1_head_group_pct.decode")


@pytest.fixture(scope="module")
def readers():
    with open(os.path.join(os.path.dirname(harness.BENCH_DIR),
                           "BENCHMARK.json")) as f:
        bench = json.load(f)
    per_layer = [m for m in bench["per_layer"] if m["name"] in NAMES]
    assert sorted(m["name"] for m in per_layer) == sorted(NAMES)
    for m in per_layer:
        assert (m["source"], m["layer"], m["unit"]) == (
            "program_counter", "B1 window attention", "%")
    return harness.load_readers(per_layer)


def _calls(monkeypatch, phase, bodies):
    """Records of one recorded codec call of `phase` a body (the profiler's
    flag set by hand), each with 2 images; returns a reader's context for
    them."""
    monkeypatch.setattr(tracing._profiler, "_is_profiler_enabled", True)

    class Codec:
        @tracing.traced(phase, "tail")
        def call(self, body, probe=None):
            body()
            return {"symbols": [torch.zeros(2)]}

    for body in bodies:
        Codec().call(body)
    return SimpleNamespace(
        trace=SimpleNamespace(calls={phase: [(0.0, 1e12)] * len(bodies)}),
        images={phase: 2 * len(bodies)})


def _count(head_group, window):
    counter = tracing.flop_counter()
    tracing.count_b1(counter, True, head_group)
    tracing.count_b1(counter, False, window)


@pytest.mark.parametrize("name", NAMES)
def test_head_group_share_holds_graph_replays(readers, monkeypatch, name):
    """Two calls: an eager one (head group 300, window 100 FLOPs) and one
    that replays twice a graph whose capture counted head group 500,
    window 20, plus its own window 60: (300 + 1000) / (1300 + 200) =
    86.67%."""
    phase = name.split(".")[1]
    with tracing.capturing(tracing.FlopSums()) as graph:
        _count(500, 20)

    def replays():
        tracing.replayed(graph)
        tracing.replayed(graph)
        _count(0, 60)

    ctx = _calls(monkeypatch, phase, [lambda: _count(300, 100), replays])
    assert readers[name](ctx) == pytest.approx(100.0 * 1300 / 1500)


@pytest.mark.parametrize("name", NAMES)
def test_head_group_share_reads_nothing_without_counters(readers,
                                                         monkeypatch, name):
    """Records without the counters (a program that does not count B1 by
    design) or without a B1 launch read nothing, so the line leaves the
    metric out; records of the window design alone read 0."""
    phase = name.split(".")[1]
    ctx = _calls(monkeypatch, phase, [lambda: _count(0, 0)])
    assert readers[name](ctx) is None
    ctx = _calls(monkeypatch, phase, [lambda: _count(0, 50)])
    assert readers[name](ctx) == 0.0
    recs = program.records(ctx, phase)
    bare = [SimpleNamespace(**{k: getattr(r, k) for k in
                               ("phase", "spans", "images")}) for r in recs]
    monkeypatch.setattr(tracing, "calls", lambda: bare)
    assert readers[name](ctx) is None
