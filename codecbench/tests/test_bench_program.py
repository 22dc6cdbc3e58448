"""The readers of the program's own spans and counters
(`harness/program.py`) on a tiny traced CPU run, and their refusal of
records that do not match the traced window's calls."""

import json
import os
import sys
from types import SimpleNamespace

import pytest

import _tiny
import stf_tpu_torch.utils
from codecbench.harness import cell as harness
from codecbench.harness import program
from stf_tpu_torch.ans import lane_coder as lc
from stf_tpu_torch.utils import tracing

READ = ("host_self_ms_per_image", "z_code_ms_per_image", "lane_framing_pct",
        "fused_miss_pct", "host_ms_per_image")


@pytest.fixture(scope="module")
def traced():
    """The kodak24 twins of the program's metrics and of
    host_ms_per_image, read from a traced run of the tiny WACNN cell (3
    requests of 2 images at pipeline 2: 8 lane segments a stream)."""
    with open(os.path.join(os.path.dirname(harness.BENCH_DIR), "BENCHMARK.json")) as f:
        bench = json.load(f)
    per_layer = [m for m in bench["per_layer"] if m["name"].startswith(READ)
                 and not m["name"].endswith(".single")]
    result = _tiny.run("cnn", traced=True, per_layer=per_layer)
    return result["metrics"], tracing.calls()


def _value(metrics, name):
    return metrics[name]["value"]


def test_every_program_metric_is_read(traced):
    metrics, _ = traced
    for name in ("host_self_ms_per_image.encode", "host_self_ms_per_image.decode",
                 "z_code_ms_per_image.encode", "z_code_ms_per_image.decode",
                 "lane_framing_pct", "fused_miss_pct.encode",
                 "fused_miss_pct.decode"):
        assert name in metrics, name


def test_host_self_time_holds_z_coding_and_lies_inside_the_probe_spans(traced):
    """z coding is one of the host spans, and the host spans lie inside
    the harness's synchronised host probe spans."""
    metrics, _ = traced
    for phase in ("encode", "decode"):
        z = _value(metrics, f"z_code_ms_per_image.{phase}")
        own = _value(metrics, f"host_self_ms_per_image.{phase}")
        assert 0 < z <= own <= _value(metrics, f"host_ms_per_image.{phase}")


def test_framing_share_is_the_lane_formats_arithmetic(traced):
    """The window's 3 compress calls: each stream's framing is the header,
    8 index hashes and `fixed_overhead_bytes(8)`, plus 2 bytes for each
    segment of an odd word count; on the CPU every call runs its fused
    path eagerly, so every call misses a graph replay."""
    metrics, calls = traced
    enc = [c for c in calls if c.phase == "encode"][-3:]
    for c in enc:
        pad = c.framing_bytes - 4 - 4 * 8 - lc.fixed_overhead_bytes(8)
        assert pad in range(0, 17, 2)
        assert c.outcome == "eager" and c.images == 2
    share = 100.0 * sum(c.framing_bytes for c in enc) / sum(
        c.y_bytes + c.z_bytes for c in enc)
    assert _value(metrics, "lane_framing_pct") == pytest.approx(share)
    assert _value(metrics, "fused_miss_pct.encode") == 100.0
    assert _value(metrics, "fused_miss_pct.decode") == 100.0


def _ctx(n_calls, images):
    return SimpleNamespace(trace=SimpleNamespace(calls={"encode": [(0.0, 1e12)] * n_calls}),
                           images={"encode": images})


def test_records_are_refused_unless_they_match_the_window(traced, monkeypatch):
    _, calls = traced
    enc = [c for c in calls if c.phase == "encode"]
    assert program.records(_ctx(3, 6), "encode") == enc[-3:]
    assert program.records(_ctx(len(enc) + 1, 6), "encode") is None
    assert program.records(_ctx(3, 5), "encode") is None
    assert program.records(_ctx(0, 0), "encode") is None
    # a record longer than its call's range belongs to another call
    short = SimpleNamespace(trace=SimpleNamespace(calls={"encode": [(0.0, 1.0)] * 3}),
                            images={"encode": 6})
    assert program.records(short, "encode") is None
    # a program without the tracing module: every reader reads nothing
    monkeypatch.delattr(stf_tpu_torch.utils, "tracing")
    monkeypatch.setitem(sys.modules, "stf_tpu_torch.utils.tracing", None)
    assert program.records(_ctx(3, 6), "encode") is None
    assert program.lane_framing_pct(_ctx(3, 6)) is None
