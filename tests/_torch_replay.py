"""Random draws shared by a port training step and the JAX step: the
port's sampler draws; `RecordingSampler` keeps a NumPy copy of each draw,
and `replay_draws` hands the copies, in draw order, to the JAX step through
a test-side monkeypatch of `jax.random.uniform`, `bernoulli` and `gumbel`
(each call checked for its shape). `jax.random.gumbel` is replaced itself:
it draws through `uniform` inside, which would otherwise take a recorded
uniform draw in the gumbel's place."""

import jax
import jax.numpy as jnp
import numpy as np


class RecordingSampler:
    """Wraps the trainer's sampler and keeps a NumPy copy of each draw."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.uniform_draws, self.bernoulli_draws = [], []
        self.gumbel_draws = []

    def uniform(self, shape, like, batch_axis=0):
        u = self.sampler.uniform(shape, like, batch_axis)
        self.uniform_draws.append(u.numpy().copy())
        return u

    def bernoulli(self, p, shape, like):
        m = self.sampler.bernoulli(p, shape, like)
        self.bernoulli_draws.append((p, m.numpy().copy()))
        return m

    def gumbel(self, shape, like):
        g = self.sampler.gumbel(shape, like)
        self.gumbel_draws.append(g.numpy().copy())
        return g


def replay_draws(monkeypatch, uniforms, bernoullis, gumbels=()):
    """Make jax.random.uniform / bernoulli / gumbel return the recorded
    draws in order; returns the three queues, which must end empty. Flax
    checks each parameter's shape by running its initializer under
    `jax.eval_shape` (some initializers draw U(-1/2, 1/2) too): those
    calls get the real functions."""
    uq, bq, gq = list(uniforms), list(bernoullis), list(gumbels)
    real = (jax.random.uniform, jax.random.bernoulli, jax.eval_shape)
    checking = []

    def eval_shape(*a, **k):
        checking.append(1)
        try:
            return real[2](*a, **k)
        finally:
            checking.pop()

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if checking:
            return real[0](key, shape, dtype, minval, maxval)
        assert (minval, maxval) == (-0.5, 0.5)
        u = uq.pop(0)
        assert tuple(shape) == u.shape, (shape, u.shape)
        return jnp.asarray(u, dtype)

    def bernoulli(key, p=0.5, shape=None):
        if checking:
            return real[1](key, p, shape)
        keep, m = bq.pop(0)
        assert tuple(shape) == m.shape and np.isclose(float(p), keep)
        return jnp.asarray(m)

    def gumbel(key, shape=(), dtype=jnp.float32, mode=None):
        g = gq.pop(0)
        assert tuple(shape) == g.shape, (shape, g.shape)
        return jnp.asarray(g, dtype)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(jax.random, "gumbel", gumbel)
    monkeypatch.setattr(jax, "eval_shape", eval_shape)
    return uq, bq, gq
