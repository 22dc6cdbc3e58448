"""bf16 comparison helpers for the port's tests. Imports no JAX, so the
card tests (`tests/test_torch_cuda.py`) use them as the CPU tests do."""

import torch


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 values lie between a and b (bf16), element by element
    (0: equal, 1: adjacent)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (ordered(a) - ordered(b)).abs()


def ulp_errors(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in bf16 ulps of want, the ulp taken at no less than
    2^-12 of want's largest magnitude (bf16's ulp over [2^e, 2^(e+1)) is
    2^(e-7)). Below that floor an attention output is the cancellation of
    much larger P * v terms, and the order of an f32 sum alone moves it
    by more than its own ulp."""
    g, w = got.float(), want.float()
    mag = torch.clamp(w.abs(), min=w.abs().max().item() * 2.0 ** -12)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
