"""The readers of `deconv_kernel_pct.*` (`harness/deconv_route.py`) on
synthetic records of the program's codec calls: the share of
ConvTranspose2d FLOPs that ran on the 3xTF32 kernel's sub-pixel phases, a
replayed graph's captured sums included, apart from Conv2d's, and nothing
read from records without the counters."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from codecbench.harness import cell as harness
from codecbench.harness import program
from stf_tpu_torch.utils import tracing

NAMES = ("deconv_kernel_pct.decode", "deconv_kernel_pct.decode.single")


@pytest.fixture(scope="module")
def readers():
    with open(os.path.join(os.path.dirname(harness.BENCH_DIR),
                           "BENCHMARK.json")) as f:
        bench = json.load(f)
    per_layer = [m for m in bench["per_layer"] if m["name"] in NAMES]
    assert sorted(m["name"] for m in per_layer) == sorted(NAMES)
    for m in per_layer:
        assert (m["source"], m["layer"], m["unit"]) == (
            "program_counter", "transforms", "%")
        assert m["workloads"] == (["wacnn.single"] if m["name"].endswith(
            "single") else ["wacnn.kodak24"])
    return harness.load_readers(per_layer)


def _calls(monkeypatch, bodies):
    """Records of one recorded decode call a body (the profiler's flag set
    by hand), each with 2 images; returns a reader's context for them."""
    monkeypatch.setattr(tracing._profiler, "_is_profiler_enabled", True)

    class Codec:
        @tracing.traced("decode", "tail")
        def call(self, body, probe=None):
            body()
            return {"symbols": [torch.zeros(2)]}

    for body in bodies:
        Codec().call(body)
    return SimpleNamespace(
        trace=SimpleNamespace(calls={"decode": [(0.0, 1e12)] * len(bodies)}),
        images={"decode": 2 * len(bodies)})


def _count(kernel, library, conv=0):
    counter = tracing.flop_counter()
    tracing.count_deconv(counter, True, kernel)
    tracing.count_deconv(counter, False, library)
    tracing.count_conv(counter, False, conv)


@pytest.mark.parametrize("name", NAMES)
def test_deconv_kernel_share_holds_graph_replays(readers, monkeypatch, name):
    """Two calls: an eager one (kernel 300, library 100 FLOPs, and Conv2d
    FLOPs on the library, which do not count) and one that replays twice
    a graph whose capture counted kernel 500, plus its own library 100:
    (300 + 1000) / (1300 + 200) = 86.67%."""
    with tracing.capturing(tracing.FlopSums()) as graph:
        _count(500, 0)

    def replays():
        tracing.replayed(graph)
        tracing.replayed(graph)
        _count(0, 100)

    ctx = _calls(monkeypatch, [lambda: _count(300, 100, conv=10 ** 6),
                               replays])
    assert readers[name](ctx) == pytest.approx(100.0 * 1300 / 1500)


@pytest.mark.parametrize("name", NAMES)
def test_deconv_kernel_share_reads_nothing_without_counters(readers,
                                                            monkeypatch,
                                                            name):
    """Records without the counters (a program without the kernel's
    phases) or without a transposed convolution read nothing, so the line
    leaves the metric out; records of the library alone read 0."""
    ctx = _calls(monkeypatch, [lambda: _count(0, 0, conv=50)])
    assert readers[name](ctx) is None
    ctx = _calls(monkeypatch, [lambda: _count(0, 50)])
    assert readers[name](ctx) == 0.0
    recs = program.records(ctx, "decode")
    bare = [SimpleNamespace(**{k: getattr(r, k) for k in
                               ("phase", "spans", "images",
                                "conv_kernel_flops", "conv_library_flops")})
            for r in recs]
    monkeypatch.setattr(tracing, "calls", lambda: bare)
    assert readers[name](ctx) is None
