"""The training forward's random draws, from one explicit generator.

The JAX step draws from key streams (`noise`, `droppath`); the port draws
every value from one `torch.Generator` on the model's device, in the
order the forward asks: the analysis's DropPath masks (and DYSTF's
Gumbel noise, each predictor's drawn when it scores, between the masks
of the blocks around it), z's noise, each slice's noise, then the
synthesis's masks. Shapes are the JAX package's, so a test can record a
`Sampler`'s draws and hand the same values to the JAX step.
"""

import torch


class Sampler:
    """U(-1/2, 1/2) noise, Bernoulli masks and Gumbel noise from
    `generator`."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def uniform(self, shape, like: torch.Tensor) -> torch.Tensor:
        """U(-1/2, 1/2) of `shape`, on like's device and in its dtype."""
        u = torch.rand(shape, generator=self.generator, device=like.device,
                       dtype=like.dtype)
        return u - 0.5

    def bernoulli(self, p: float, shape, like: torch.Tensor) -> torch.Tensor:
        """A bool mask of `shape`, each entry True with probability p."""
        u = torch.rand(shape, generator=self.generator, device=like.device,
                       dtype=like.dtype)
        return u < p

    def gumbel(self, shape, like: torch.Tensor) -> torch.Tensor:
        """Standard Gumbel noise -log(-log(u)) of `shape`, u uniform in
        [finfo.tiny, 1) as `jax.random.gumbel` draws it (a u of 0 would
        give inf)."""
        u = torch.rand(shape, generator=self.generator, device=like.device,
                       dtype=like.dtype)
        u = u.clamp_min(torch.finfo(like.dtype).tiny)
        return -torch.log(-torch.log(u))
