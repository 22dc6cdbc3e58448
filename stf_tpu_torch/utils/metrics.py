"""Image quality metrics (port of `stf_tpu/utils/metrics.py`, PSNR only)."""

import torch


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0):
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse)
