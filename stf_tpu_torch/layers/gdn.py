"""Generalized Divisive Normalization (port of `stf_tpu/layers/gdn.py`).

y[i] = x[i] / sqrt(beta[i] + sum_j gamma[i,j] x[j]^2) — reference
`compressai/layers/gdn.py:26-104`; the sum is a 1x1 conv over x^2 (NCHW).
beta/gamma are stored in NonNegativeParametrizer space; parameter names are
the reference's (`g_a.1.beta`, `g_a.1.gamma`).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import NonNegativeParametrizer


class GDN(nn.Module):
    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1):
        super().__init__()
        self.inverse = bool(inverse)
        self.beta_reparam = NonNegativeParametrizer(minimum=beta_min)
        self.gamma_reparam = NonNegativeParametrizer()
        self.gamma_init = float(gamma_init)
        self.beta = nn.Parameter(torch.empty(channels))
        self.gamma = nn.Parameter(torch.empty(channels, channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        del generator  # deterministic init
        with torch.no_grad():
            C = self.beta.shape[0]
            self.beta.copy_(self.beta_reparam.init(torch.ones(C)))
            self.gamma.copy_(
                self.gamma_reparam.init(self.gamma_init * torch.eye(C))
            )

    def forward(self, x):
        # the reparametrisation runs in the parameters' own dtype and its
        # result meets x in x's: a bf16 codec's f32 synthesis keeps GDN's
        # parameters in bf16, as the JAX codec's promotion does (flax
        # computes beta_reparam(beta) in bf16, then promotes it)
        beta = self.beta_reparam(self.beta).to(x.dtype)
        gamma = self.gamma_reparam(self.gamma).to(x.dtype)  # (C_out, C_in)
        norm = F.conv2d(x * x, gamma[:, :, None, None], beta)
        norm = torch.sqrt(norm) if self.inverse else torch.rsqrt(norm)
        return x * norm
