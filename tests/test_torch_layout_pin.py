"""Kernel B4's planner (`pin_plan`) on the CPU: for each view the path it
picks (packed, transpose or general), and that the merged geometry it
hands the kernel describes the same elements in the same order (a copy rebuilt from the plan alone equals
`layout_pin_plain` bit for bit). The kernel itself runs on the card
(`tests/test_torch_cuda.py::test_layout_pin_kernel_is_bit_exact`)."""

import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu_torch.ans import lane_coder as lc


def _views():
    g = torch.Generator().manual_seed(5)
    f32 = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    i32 = lambda *s: torch.randint(  # noqa: E731
        -(2**31), 2**31 - 1, s, generator=g, dtype=torch.int32)
    u8 = torch.randint(0, 256, (3, 7, 11, 5), generator=g).to(torch.uint8)
    bf16 = f32(13, 129).to(torch.bfloat16)
    return {
        # (view, expected kind, expected merged sizes or None)
        "packed mu": (f32(2, 32, 32, 48), "packed", (2 * 32 * 32 * 48,)),
        "cropped lm": (f32(2, 320, 36, 52)[:, :, :32, :48], "general",
                       (640, 32, 48)),
        "full-size crop is packed": (f32(2, 320, 32, 48)[:, :, :32, :48],
                                     "packed", (2 * 320 * 32 * 48,)),
        "rv NHWC as NCHW": (i32(2, 32, 48, 32).permute(0, 3, 1, 2),
                            "transpose", (2, 32, 1536)),
        "z_hat NHWC as NCHW": (f32(2, 8, 12, 192).permute(0, 3, 1, 2),
                               "transpose", (2, 192, 96)),
        "1-d": (f32(999), "packed", (999,)),
        "misaligned flat": (f32(4, 5).reshape(-1)[1:], "packed", (19,)),
        "expanded stride 0": (f32(3, 1, 5).expand(3, 4, 5), "general", None),
        "permuted outer dims": (f32(2, 3, 4, 5).permute(2, 0, 3, 1),
                                "transpose", (4, 2, 5, 3)),
        "doubly permuted": (f32(2, 3, 4, 5).permute(3, 1, 2, 0), "general",
                            None),
        "odd uint8": (u8, "packed", (3 * 7 * 11 * 5,)),
        "odd uint8 permuted": (u8.permute(0, 3, 1, 2), "transpose",
                               (3, 5, 77)),
        "odd bf16 cropped": (bf16[:, 1:], "general", (13, 128)),
        "size-1 dims": (f32(1, 6, 1, 7)[:, :, :, 2:], "general", (6, 5)),
    }


@pytest.mark.parametrize("case", list(_views()))
def test_pin_plan_picks_the_path_and_keeps_the_elements(case):
    x, kind, sizes = _views()[case]
    plan = lc.pin_plan(x.shape, x.stride(), x.element_size(), x.data_ptr())
    assert plan.kind == kind
    if sizes is not None:
        assert plan.sizes == sizes
    assert len(plan.sizes) == len(plan.strides) <= 4
    assert plan.word % x.element_size() == 0 and plan.word <= 16
    assert x.data_ptr() % plan.word == 0
    if kind != "packed":
        assert plan.word == x.element_size()
    elif x.data_ptr() % 16 == 0:
        assert plan.word == 16
    rebuilt = torch.as_strided(x, plan.sizes, plan.strides, x.storage_offset())
    want = lc.layout_pin_plain(x)
    got = rebuilt.contiguous().reshape(x.shape)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
