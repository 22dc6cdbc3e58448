"""The training forward's random draws, from one explicit generator.

The JAX step draws from key streams (`noise`, `droppath`); the port draws
every value from one `torch.Generator` on the model's device, in the
order the forward asks: the analysis's DropPath masks (and DYSTF's
Gumbel noise, each predictor's drawn when it scores, between the masks
of the blocks around it), z's noise, each slice's noise, then the
synthesis's masks. Shapes are the JAX package's, so a test can record a
`Sampler`'s draws and hand the same values to the JAX step.

Under data parallelism the JAX step draws for the global batch. A rank
here computes only its share, so with `shard = (index, count)` every
draw is made at the global batch's shape (the batch axis `count` times
the local one) from the generator that every rank seeds alike, and the
rank keeps its rows: its values are the single-process draw's rows, and
every generator stays in step with the single process's. With the
default (0, 1) each draw is the one a single process makes.
"""

from typing import Tuple

import torch


class Sampler:
    """U(-1/2, 1/2) noise, Bernoulli masks and Gumbel noise from
    `generator`, for this rank's `shard` of the global batch."""

    def __init__(self, generator: torch.Generator,
                 shard: Tuple[int, int] = (0, 1)):
        self.generator = generator
        self.shard = tuple(shard)

    def _rand(self, shape, like: torch.Tensor, batch_axis: int = 0):
        """U[0, 1) of `shape`: this rank's rows, along `batch_axis`, of
        the draw at the global batch."""
        index, count = self.shard
        if count == 1:
            return torch.rand(shape, generator=self.generator,
                              device=like.device, dtype=like.dtype)
        shape = list(shape)
        n = shape[batch_axis]
        shape[batch_axis] = n * count
        u = torch.rand(shape, generator=self.generator, device=like.device,
                       dtype=like.dtype)
        return u.narrow(batch_axis, index * n, n).contiguous()

    def uniform(self, shape, like: torch.Tensor,
                batch_axis: int = 0) -> torch.Tensor:
        """U(-1/2, 1/2) of `shape`, on like's device and in its dtype;
        `batch_axis` is the axis that runs over the batch's images (the
        entropy bottleneck's flattened (C, 1, B*H*W) draw has it last)."""
        return self._rand(shape, like, batch_axis) - 0.5

    def bernoulli(self, p: float, shape, like: torch.Tensor) -> torch.Tensor:
        """A bool mask of `shape`, each entry True with probability p."""
        return self._rand(shape, like) < p

    def gumbel(self, shape, like: torch.Tensor) -> torch.Tensor:
        """Standard Gumbel noise -log(-log(u)) of `shape`, u uniform in
        [finfo.tiny, 1) as `jax.random.gumbel` draws it (a u of 0 would
        give inf)."""
        u = self._rand(shape, like).clamp_min(torch.finfo(like.dtype).tiny)
        return -torch.log(-torch.log(u))
