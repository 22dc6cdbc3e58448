"""Non-negative reparametrization used by GDN's beta/gamma.

Port of `stf_tpu/ops/parametrizers.py`; the pedestal/offset math is the
reference's exactly (it is load-bearing for training stability): parameters
are stored as ``sqrt(v + pedestal)`` and decoded as
``lower_bound(x, sqrt(minimum + pedestal))**2 - pedestal``.

On bf16 parameters every step rounds to bf16 where the JAX package's
does (its Python-float bound and pedestal are weakly typed, so they meet
a bf16 array as bf16): the bound and the pedestal are exact in bf16 or
change no comparison, and the square and the subtraction round once each
in both packages (tests/test_torch_bf16.py holds the results bit-equal).
"""

import torch

from .bound_ops import lower_bound


class NonNegativeParametrizer:
    """Stateless helper: `init` encodes raw values, `__call__` decodes them."""

    def __init__(self, minimum: float = 0.0, reparam_offset: float = 2 ** -18):
        self.minimum = float(minimum)
        self.reparam_offset = float(reparam_offset)
        self.pedestal = self.reparam_offset ** 2
        self.bound = (self.minimum + self.pedestal) ** 0.5

    def init(self, x: torch.Tensor) -> torch.Tensor:
        """Map an initial (non-negative) value to its stored representation."""
        return torch.sqrt(torch.clamp_min(x + self.pedestal, self.pedestal))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Decode the stored representation back to a >= minimum value."""
        out = lower_bound(x, self.bound)
        return out * out - self.pedestal
