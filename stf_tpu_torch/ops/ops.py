"""Straight-through-estimator rounding (port of `stf_tpu/ops/ops.py`):
the forward value is ``round(x)`` (half to even) and the gradient is the
identity."""

import torch


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return x + (torch.round(x) - x).detach()
