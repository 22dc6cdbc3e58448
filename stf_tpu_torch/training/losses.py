"""Rate-distortion losses (port of `stf_tpu/training/losses.py`).

loss = lambda * 255^2 * MSE + bpp ("mse"), or lambda * (1 - MS-SSIM) +
bpp ("ms-ssim"), where bpp sums -log2(likelihood) over every latent per
pixel. Targets and reconstructions are NHWC.
"""

import math
from typing import Dict, NamedTuple

import torch

from ..utils.metrics import ms_ssim


class RDLossOutput(NamedTuple):
    loss: torch.Tensor
    bpp_loss: torch.Tensor
    distortion: torch.Tensor


def bpp_from_likelihoods(likelihoods: Dict[str, torch.Tensor],
                         num_pixels: int) -> torch.Tensor:
    total = 0.0
    for lik in likelihoods.values():
        total = total + torch.sum(-torch.log(lik))
    return total / (math.log(2) * num_pixels)


def rate_distortion_loss(output: Dict, target: torch.Tensor, lmbda: float,
                         metric: str = "mse") -> RDLossOutput:
    B, H, W, _ = target.shape
    bpp = bpp_from_likelihoods(output["likelihoods"], B * H * W)
    if metric == "mse":
        dist = torch.mean((output["x_hat"] - target) ** 2)
        loss = lmbda * 255 ** 2 * dist + bpp
    elif metric == "ms-ssim":
        dist = 1.0 - ms_ssim(output["x_hat"], target)
        loss = lmbda * dist + bpp
    else:
        raise ValueError(f"unknown distortion metric {metric!r}")
    return RDLossOutput(loss=loss, bpp_loss=bpp, distortion=dist)
