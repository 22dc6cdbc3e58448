"""On the card: a cell at its own size is correct on three seeds, and its
control (the reference one precision lower in the program's place) is
not. Marked `cuda`; skips without a card."""

import json
import os

import pytest
import torch

from codecbench.harness import cell as harness

pytestmark = pytest.mark.cuda

with open(os.path.join(harness.REPO, "BENCHMARK.json")) as f:
    WORKLOADS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_is_correct_and_its_control_is_not(card, workload):
    from codecbench.calibrate import readings

    for line in readings(workload, [2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3], 2.0):
        assert line["correct"] and line["failed"] == 0, line
        assert not line["control_correct"], line
