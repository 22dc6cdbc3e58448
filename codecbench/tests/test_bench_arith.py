"""The yardstick's arithmetic on synthetic inputs."""

import pytest

from codecbench.harness import arith, cell as harness, trace as tr


@pytest.mark.parametrize("shape,ws,nh,dtype,bound", [
    ((2, 128, 192, 576), 8, 8, "float32", 0.0451),    # WACNN g_a / g_s, 8x8
    ((2, 256, 384, 144), 4, 3, "float32", 0.0452),    # STF stage 0
    ((24, 128, 192, 576), 8, 8, "bfloat16", 0.2705),  # WACNN g_a at batch 24
    ((8, 256, 384, 144), 4, 3, "bfloat16", 0.0903),   # STF stage 0, chunk of 8
])
def test_b1_bound_gives_the_kernel_tables_bound(shape, ws, nh, dtype, bound):
    """PERF.md's kernel table: B1's bound ms at its measured shapes."""
    assert round(arith.b1_bound_ms(shape, ws, nh, True, dtype), 4) == bound


def test_overlapping_intervals_never_read_over_the_window():
    # two streams' kernels overlapping: summed they read 150% busy
    intervals = [(0, 60), (10, 70), (50, 100), (80, 90)]
    assert sum(b - a for a, b in intervals) > 100
    assert arith.union_length(intervals) == 100
    assert arith.gaps(intervals, 0, 120) == [(100, 120)]


def _events(calls, kernels, spans=()):
    ev = [{"ph": "X", "cat": "user_annotation", "name": f"codecbench.{p}",
           "ts": a, "dur": b - a} for p, a, b in calls]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a}
           for n, a, b in kernels]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "codecbench.span",
            "ts": a, "dur": b - a} for a, b in spans]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": a - 1, "dur": 1} for _, a, _ in kernels]
    return ev


def test_trace_busy_share_is_the_union_and_never_over_100():
    t = tr.Trace(_events([("encode", 0, 100), ("decode", 100, 200)],
                         [("implicit_gemm_a", 5, 80), ("window_attention_b", 10, 90),
                          ("lane_decode_kernel", 120, 150)],
                         [(0, 50), (50, 100), (100, 200)]),
                 [("encode", "walk"), ("encode", "tail"), ("decode", "tail")])
    assert t.busy_us("encode") == 85
    assert t.busy_us("encode") <= t.wall_us("encode")
    assert t.launch_count("encode") == 2 and t.launch_count("decode") == 1
    assert t.span_us("encode", ("walk",)) == 50
    assert {arith.kernel_group(n): t1 - t0 for n, t0, t1, _ in t.device_ops("encode")} \
        == {"convolution": 75, "B1": 80}
    gaps = t.idle_gaps()
    assert gaps[0][0] == "decode:tail" and gaps[0][1] == pytest.approx(50e-6)


def _done(enc_ms):
    return [harness.Done(0, 1, 512 * 768, e / 1e3, 0.02, 1000, 1200, 0) for e in enc_ms]


def test_a_stall_moves_the_encode_rate_and_the_tail():
    names = ["encode_ms_per_image", "roundtrip_p95_ms"]
    steady = harness.end_to_end(_done([10.0] * 100), 1.0, names)
    # a stall that holds up 6 requests of 100 by 40 ms each
    stalled = harness.end_to_end(_done([10.0] * 94 + [50.0] * 6), 1.0, names)
    assert stalled["encode_ms_per_image"]["value"] > steady["encode_ms_per_image"]["value"] * 1.2
    assert stalled["roundtrip_p95_ms"]["value"] > steady["roundtrip_p95_ms"]["value"] + 30


def test_p95_is_the_nearest_rank():
    assert arith.p95(list(range(1, 101))) == 95
    assert arith.p95([3.0]) == 3.0


@pytest.mark.parametrize("model,codec,batch,launches", [
    ("cnn", {"dtype": "bfloat16"}, 24, (2, 2)),
    ("stf", {"dtype": "bfloat16", "analyze_chunks": 3, "synth_chunks": 3}, 24, (36, 36)),
    ("stf", {"dtype": "bfloat16", "analyze_chunks": 3, "synth_chunks": 3}, 1, (12, 12)),
])
def test_phase_costs_count_b1_launches_a_call(model, codec, batch, launches):
    c = arith.phase_costs(model, {}, codec, batch, (512, 768), flops=False)
    assert (len(c["encode"]["b1"]), len(c["decode"]["b1"])) == launches


def test_flops_scale_with_the_batch_and_split_by_dtype():
    one = arith.phase_costs("cnn", {}, {"dtype": "bfloat16"}, 1, (512, 768))
    two = arith.phase_costs("cnn", {}, {"dtype": "bfloat16"}, 2, (512, 768))
    assert set(one["encode"]["flops"]) == {"bfloat16", "float32"}
    assert set(one["decode"]["flops"]) == {"float32"}
    for phase in ("encode", "decode"):
        for d, n in one[phase]["flops"].items():
            assert two[phase]["flops"][d] == 2 * n > 0
