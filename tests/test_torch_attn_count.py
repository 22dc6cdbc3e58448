"""The FLOP counters of kernel B1 by design (`attention_core.count_flops`,
`utils/tracing.py`): a launch's 4 N B H W C go to the open codec call's
record under its design, a CUDA graph's capture keeps its launches' sums
apart and each replay adds them. CPU only and cheap: the counting is
Python-side, called by the launch wrapper; the card test
(`tests/test_torch_cuda.py`) holds real launches to it."""

import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu_torch.layers import attention_core as ac
from stf_tpu_torch.utils import tracing

# TBC's analysis stage 0 at batch 24 (head width 4, 32 heads, 8x8), and
# its hyper analysis (head width 6, 4x4), as the wrapper sees them
STAGE0 = (24, 256, 384, 128, 8)
HYPER = (24, 16, 24, 192, 4)


def _flops(B, H, W, C, ws):
    return 4 * ws * ws * B * H * W * C


def _record(monkeypatch, phase, body):
    """One recorded codec call of `phase` (a profiler's flag set by hand)
    whose body runs `body()`; returns its record."""
    monkeypatch.setattr(tracing._profiler, "_is_profiler_enabled", True)

    class Codec:
        @tracing.traced(phase, "tail")
        def call(self, probe=None):
            body()
            return {"symbols": [torch.zeros(1)]}

    Codec().call()
    return tracing.calls()[-1]


def test_records_count_b1_flops_by_design_and_replays(monkeypatch):
    """An eager launch adds to the call's record under its design; a
    capture keeps its launches apart (not in the call that captures) and
    each replay adds them; outside a record and a capture nothing is
    counted."""
    ac.count_flops(ac.HEAD_GROUP, *STAGE0)  # no record open
    with tracing.capturing(tracing.FlopSums()) as captured:
        ac.count_flops(ac.HEAD_GROUP, *STAGE0)
        ac.count_flops("bf16_mma", *HYPER)
    assert (captured.b1_head_group_flops, captured.b1_window_flops) == (
        _flops(*STAGE0), _flops(*HYPER))
    assert captured.conv_kernel_flops == captured.conv_library_flops == 0

    def body():
        ac.count_flops("window_head", *HYPER)
        with tracing.capturing(tracing.FlopSums()):
            ac.count_flops(ac.HEAD_GROUP, *STAGE0)  # not the call's
        tracing.replayed(captured)
        tracing.replayed(captured)

    rec = _record(monkeypatch, "encode", body)
    assert rec.b1_head_group_flops == 2 * _flops(*STAGE0)
    assert rec.b1_window_flops == 3 * _flops(*HYPER)
    assert rec.conv_kernel_flops == rec.conv_library_flops == 0
