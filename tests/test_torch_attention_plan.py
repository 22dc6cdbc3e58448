"""The host side of kernel B1's head-group design (TBC's 8x8 windows at
head widths 4, 6, 8 and 10): which design the wrapper picks, the launch
plan (head groups x window chunks) and the kernel's window walk, held
against `shifted_window_region_labels` at TBC's map sizes. CPU only; the
kernel itself is tested on the card (`test_torch_cuda.py`)."""

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu_torch.layers import attention_core as ac
from stf_tpu_torch.layers import shifted_window_region_labels

# TBC's four analysis / synthesis maps at a 512x768 input, 8x8 windows,
# 32 heads of widths 4, 6, 8 and 10
TBC_MAPS = [((256, 384), 4), ((128, 192), 6), ((64, 96), 8), ((32, 48), 10)]
GROUP = 2  # heads a block of the head-group instances
# (SMs, blocks an SM): an H100's 132 at one and two blocks, and a small card
CARDS = [(132, 1), (132, 2), (8, 1)]


@pytest.mark.parametrize("ws,hd,nh,dtype,want", [
    (8, 4, 32, torch.float32, "head_group"),
    (8, 10, 32, torch.bfloat16, "head_group"),
    (8, 8, 8, torch.float32, "head_group"),
    (8, 24, 8, torch.float32, "window_head"),
    (8, 24, 8, torch.bfloat16, "bf16_mma"),
    (4, 6, 32, torch.float32, "window_head"),
    (4, 16, 24, torch.bfloat16, "bf16_mma"),
    (8, 6, 5, torch.float32, "window_head"),  # heads not a group multiple
])
def test_main_design_takes_the_head_group_at_tbc_geometries(ws, hd, nh, dtype,
                                                            want):
    assert ac.main_design(ws, hd, nh, dtype, GROUP) == want


@pytest.mark.parametrize("sms,blocks", CARDS)
@pytest.mark.parametrize("hw,hd", TBC_MAPS)
def test_head_group_plan_covers_every_window_and_head_once(hw, hd, sms,
                                                           blocks):
    h, w = hw
    windows = 2 * (h // 8) * (w // 8)
    groups, chunks = ac.head_group_plan(windows, 32, GROUP, sms, blocks)
    assert groups == 32 // GROUP
    # one wave: every block resident at once, unless a chunk a group
    # already overfills the card
    assert groups * chunks <= max(sms * blocks, groups)
    seen = np.zeros((windows, groups), np.int64)
    for j in range(groups * chunks):
        walk = ac.head_group_walk(j // groups, chunks, windows)
        seen[walk, j % groups] += 1
    assert (seen == 1).all()
    counts = [len(ac.head_group_walk(c, chunks, windows))
              for c in range(chunks)]
    assert max(counts) - min(counts) <= 1


# the head-group instances' occupancy on an H100: bf16 2 blocks an SM,
# f32 3
@pytest.mark.parametrize("sms,blocks", [(132, 2), (132, 3)])
@pytest.mark.parametrize("hw,hd", TBC_MAPS)
def test_head_group_walk_spreads_the_mixed_windows(hw, hd, sms, blocks):
    """A shifted map's windows with mixed labels (the kernel's vote: not
    all 64 labels equal) are its last row and last column of windows; the
    walk deals them out over the chunks (at most twice the mean and two
    more), where a plain stride (chunk, chunk + chunks, ...) hands a whole
    column to one chunk."""
    h, w = hw
    labels = shifted_window_region_labels(h, w, 8, 4)
    mixed = (labels != labels[:, :1]).any(1).reshape(h // 8, w // 8)
    edge = np.zeros_like(mixed)
    edge[-1, :] = edge[:, -1] = True
    assert (mixed == edge).all()
    flat = np.concatenate([mixed.ravel()] * 2)  # batch 2
    _, chunks = ac.head_group_plan(flat.size, 32, GROUP, sms, blocks)
    per_chunk = [int(flat[ac.head_group_walk(c, chunks, flat.size)].sum())
                 for c in range(chunks)]
    strided = [int(flat[c::chunks].sum()) for c in range(chunks)]
    assert max(per_chunk) <= 2 * flat.sum() / chunks + 2
    assert max(per_chunk) <= max(strided)
