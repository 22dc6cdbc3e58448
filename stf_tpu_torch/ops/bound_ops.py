"""Lower-bound op with the identity-when-pushing-up gradient.

Port of `stf_tpu/ops/bound_ops.py` (reference `compressai/ops/bound_ops.py`):
the forward pass is ``max(x, bound)``; the backward pass lets the gradient
through wherever ``x >= bound`` *or* the incoming gradient would push ``x``
upward (``g < 0``), and zeroes it otherwise.
"""

import torch


class LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound: float):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        # the bound is a hyperparameter, never trained
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return LowerBound.apply(x, float(bound))
