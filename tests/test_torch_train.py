"""The port's training step against the JAX trainer on the CPU, at the
same weights, batch and random draws.

The port's sampler draws the y/z noise and STF's DropPath masks; the
test records them and hands the same values to the JAX step through a
test-side `monkeypatch` of `jax.random.uniform` / `jax.random.bernoulli`
(in draw order, each call checked for its shape). Small models from
`_torch_port.pair_from_port` at 64x64, batch 2; STF keeps its drop-path
rate of 0.2, so its masks are live.

Tolerances, f32 on both sides with sums taken in other orders: loss
terms rel 1e-5 (bpp, the loosest, is off by 3e-6 and 4.5e-6 for the
cnn and the stf on the CPU); each parameter's gradient within 2e-4 of that
tensor's largest JAX gradient (the worst tensors, slice stacks, are at
6.0e-5 and 3.6e-5); parameters after two updates on the same gradients
within two f32 ulps plus 2e-5 of the learning rate (see the test).
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import pair_from_port, smooth_images
from stf_tpu.layers.pallas_attention import _reference_core
from stf_tpu.layers.win_attention import WindowAttention as JaxWindowAttention
from stf_tpu.layers.win_attention import shifted_window_region_labels
from stf_tpu.ops import lower_bound as jax_lower_bound
from stf_tpu.ops import ste_round as jax_ste_round
from stf_tpu.training.losses import rate_distortion_loss as jax_rd_loss
from stf_tpu.training.state import configure_optimizers
from stf_tpu_torch.layers import WindowAttention
from stf_tpu_torch.layers import attention_core as ac
from stf_tpu_torch.layers import win_attention as port_win_attention
from stf_tpu_torch.models import base as port_base
from stf_tpu_torch.ops import lower_bound, ste_round
from stf_tpu_torch.training import TrainState, make_train_step
from stf_tpu_torch.training import state as port_state
from stf_tpu_torch.zoo import state_dict_from_jax

LMBDA = 0.013
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4  # of each tensor's largest JAX gradient
PARAM_RTOL = 2.5e-7  # two f32 ulps


class RecordingSampler:
    """Wraps the trainer's sampler and keeps a NumPy copy of each draw."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.uniform_draws, self.bernoulli_draws = [], []

    def uniform(self, shape, like):
        u = self.sampler.uniform(shape, like)
        self.uniform_draws.append(u.numpy().copy())
        return u

    def bernoulli(self, p, shape, like):
        m = self.sampler.bernoulli(p, shape, like)
        self.bernoulli_draws.append((p, m.numpy().copy()))
        return m


def replay_draws(monkeypatch, uniforms, bernoullis):
    """Make jax.random.uniform / bernoulli return the recorded draws in
    order; returns the two queues, which must end empty. Flax checks each
    parameter's shape by running its initializer under `jax.eval_shape`
    (some initializers draw U(-1/2, 1/2) too): those calls get the real
    functions."""
    uq, bq = list(uniforms), list(bernoullis)
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

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(jax, "eval_shape", eval_shape)
    return uq, bq


def _batch(seed=5):
    return (smooth_images(2, 64, 64, seed) / 255.0).astype(np.float32)


def _port_step(port, x, clip=1.0):
    """One port train step from a fresh TrainState; returns (metrics,
    {name: grad before the update}, sampler)."""
    state = TrainState(port, "cpu", seed=11, clip_max_norm=clip)
    sampler = RecordingSampler(state.sampler)
    state.sampler = sampler
    grads = {}
    update = state.apply_gradients

    def apply_gradients():
        grads.update({n: p.grad.clone() for n, p in port.named_parameters()
                      if p.grad is not None})
        update()

    state.apply_gradients = apply_gradients
    metrics = make_train_step(port, LMBDA)(state, torch.from_numpy(x))
    return {k: float(v) for k, v in metrics.items()}, grads, sampler


def _jax_step(model, params, x, sampler):
    """The JAX step's loss_fn (`stf_tpu/training/state.py:96-107`) fed the
    port's draws: (metrics, gradients, params after two updates of
    `configure_optimizers` (the step's gradients, then half of them),
    with the schedule's first boundary at update 1), in one jit."""
    tx = configure_optimizers(
        optax.piecewise_constant_schedule(1e-4, {1: 0.1}), 1e-3, 1.0
    )

    def loss_fn(p, xx):
        r = jax.random.split(jax.random.key(0), 3)
        out = model.apply({"params": p}, xx, training=True,
                          rngs={"noise": r[0], "droppath": r[1],
                                "gumbel": r[2]})
        rd = jax_rd_loss(out, xx, LMBDA, "mse")
        aux = model.apply({"params": p}, method="aux_loss")
        return rd.loss + aux, (rd, aux)

    @jax.jit
    def run(p, xx):
        (_, (rd, aux)), g = jax.value_and_grad(loss_fn, has_aux=True)(p, xx)
        opt_state = tx.init(p)
        stepped = p
        for gi in (g, jax.tree_util.tree_map(lambda t: t * 0.5, g)):
            updates, opt_state = tx.update(gi, opt_state, stepped)
            stepped = optax.apply_updates(stepped, updates)
        return rd, aux, g, stepped

    with pytest.MonkeyPatch.context() as mp:
        uq, bq = replay_draws(mp, sampler.uniform_draws,
                              sampler.bernoulli_draws)
        rd, aux, grads, stepped = run(params, jnp.asarray(x))
    assert not uq and not bq, "the JAX step drew fewer values than the port"
    metrics = {"loss": float(rd.loss), "bpp_loss": float(rd.bpp_loss),
               "distortion": float(rd.distortion), "aux_loss": float(aux)}
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return metrics, as_np(grads), as_np(stepped)


@pytest.fixture(scope="module", params=["cnn", "stf"])
def step_pair(request):
    """One model's port step and JAX step at the same weights and draws."""
    name = request.param
    model, params, port = pair_from_port(0, name)
    fresh = copy.deepcopy(port)
    x = _batch()
    metrics, grads, sampler = _port_step(port, x)
    jmetrics, jgrads, jstepped = _jax_step(model, params, x, sampler)
    return SimpleNamespace(
        name=name, fresh=fresh, x=x, metrics=metrics, grads=grads,
        sampler=sampler, jmetrics=jmetrics, jgrads=jgrads,
        jstepped=state_dict_from_jax(jstepped, name),
    )


def _grad_errors(name, port_grads, jax_grads):
    """{torch name: (max abs diff, largest JAX gradient)} for every
    parameter of the port."""
    want = state_dict_from_jax(jax_grads, name)
    assert set(want) == set(port_grads), set(want) ^ set(port_grads)
    return {k: ((port_grads[k] - want[k]).abs().max().item(),
                want[k].abs().max().item()) for k in want}


def test_train_step_loss_and_gradients_match_jax(step_pair):
    sp = step_pair
    if sp.name == "stf":
        draws = sp.sampler.bernoulli_draws
        assert draws and any(not m.all() for _, m in draws), "no mask dropped"
    for k in ("loss", "bpp_loss", "distortion", "aux_loss"):
        np.testing.assert_allclose(sp.metrics[k], sp.jmetrics[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    errs = _grad_errors(sp.name, sp.grads, sp.jgrads)
    assert len(errs) == len(list(sp.fresh.parameters()))
    bad = {k: e for k, e in errs.items() if not e[0] <= GRAD_TOL * e[1]}
    assert not bad, bad
    # every parameter is trained: a gradient that is zero throughout
    # would pass the comparison above vacuously
    assert all(e[1] > 0 for e in errs.values())


def test_gradient_comparison_catches_plain_round(step_pair, monkeypatch):
    """A planted fault: y_hat and z_hat with plain rounding (no straight-
    through gradient) must fail the gradient comparison."""
    sp = step_pair
    monkeypatch.setattr(port_base, "ste_round", torch.round)
    _, grads, _ = _port_step(copy.deepcopy(sp.fresh), sp.x)
    errs = _grad_errors(sp.name, grads, sp.jgrads)
    bad = [k for k, e in errs.items() if not e[0] <= GRAD_TOL * e[1]]
    assert any(k.startswith("g_a." if sp.name == "cnn" else "layers.")
               for k in bad)
    assert any(k.startswith("h_a.") for k in bad)


def _port_steps(port, name, grads, clip=1.0):
    """The port's update on the JAX gradients and on half of them, with
    the schedule's first boundary at update 1."""
    g = state_dict_from_jax(grads, name)
    state = TrainState(port, "cpu", clip_max_norm=clip, lr_milestones=[1])
    for scale in (1.0, 0.5):
        for n, p in port.named_parameters():
            p.grad = g[n] * scale
        state.apply_gradients()
    return port.state_dict()


def test_parameters_after_the_step_match_optax(step_pair):
    """The JAX step's own gradients through the port's update (clip over
    the main group, dual Adam, schedule) and through
    `configure_optimizers`. The first update's global norm is far over
    the clip; the second (half the gradients, the learning rate scaled
    by the schedule) shows the clip's effect on Adam's moments.

    Tolerance: two f32 ulps of the parameter, plus 2e-5 of the group's
    learning rate: optax takes Adam's bias corrections 1 - b^t in f32,
    where 1 - 0.999^2 cancels to ~1.5e-5 relative error, torch in f64."""
    sp = step_pair
    main = [g for k, g in state_dict_from_jax(sp.jgrads, sp.name).items()
            if "quantiles" not in k]
    norm = torch.sqrt(sum((g * g).sum() for g in main)).item()
    assert norm > 10, norm  # the clip is active
    got = _port_steps(copy.deepcopy(sp.fresh), sp.name, sp.jgrads)
    for k, w in sp.jstepped.items():
        lr = 1e-3 if "quantiles" in k else 1e-4
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=PARAM_RTOL,
                                   atol=2e-5 * lr, err_msg=k)


def test_parameter_comparison_catches_a_missing_clip(step_pair):
    sp = step_pair
    got = _port_steps(copy.deepcopy(sp.fresh), sp.name, sp.jgrads, clip=0.0)
    worst = max((got[k] - w).abs().max().item()
                for k, w in sp.jstepped.items())
    assert worst > 1e-5, worst


def test_rd_and_aux_gradients_split(step_pair):
    """The RD loss leaves `quantiles` untouched and the aux loss touches
    only them (`tests/test_cnn_model.py:54-92` for JAX)."""
    sp = step_pair
    port = copy.deepcopy(sp.fresh).train()
    x = torch.from_numpy(sp.x)
    state = TrainState(port, "cpu", seed=2)
    out = port(x, training=True, sampler=state.sampler)
    port_state.rate_distortion_loss(out, x, LMBDA).loss.backward()
    for n, p in port.named_parameters():
        if port_state.is_aux_parameter(n):
            assert p.grad is None or not p.grad.any(), n
    first = "g_a." if sp.name == "cnn" else "layers."
    assert any(p.grad is not None and p.grad.any()
               for n, p in port.named_parameters() if n.startswith(first))
    state.zero_grad()
    port.aux_loss().backward()
    for n, p in port.named_parameters():
        if port_state.is_aux_parameter(n):
            assert p.grad is not None and p.grad.any(), n
        else:
            assert p.grad is None or not p.grad.any(), n
    assert len(state.aux_params) == 1


@pytest.mark.parametrize("x", [[-2.0, 0.05, 0.2, 3.0]])
def test_bound_and_ste_gradients_match_jax(x):
    """lower_bound's gradient passes where x >= bound or the gradient
    pushes x up; ste_round's is the identity: both against jax.grad."""
    xs = np.asarray(x, np.float32)
    for sign in (1.0, -1.0):
        t = torch.tensor(xs, requires_grad=True)
        (sign * lower_bound(t, 0.11)).sum().backward()
        want = jax.grad(lambda v: (sign * jax_lower_bound(v, 0.11)).sum())(
            jnp.asarray(xs))
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    t = torch.tensor(xs + 0.3, requires_grad=True)
    (ste_round(t) * torch.arange(4.0)).sum().backward()
    want = jax.grad(lambda v: (jax_ste_round(v) * jnp.arange(4.0)).sum())(
        jnp.asarray(xs + 0.3))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


def _partition_np(qkv, ws, nh):
    B, H, W, C3 = qkv.shape
    hd = C3 // 3 // nh
    t = qkv.reshape(B, H // ws, ws, W // ws, ws, 3, nh, hd)
    t = t.transpose(5, 0, 1, 3, 6, 2, 4, 7).reshape(3, -1, nh, ws * ws, hd)
    return t[0], t[1], t[2]


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ws,hd", [(8, 24), (4, 40), (4, 16)])
def test_b1_backward_matches_jax_reference_core(ws, hd, shifted):
    """B1's Function (its forward the plain version on the CPU, its
    backward the closed form) against jax.grad of `_reference_core`."""
    nh, C = 8, 8 * hd
    H, W = 2 * ws, 3 * ws
    rng = np.random.default_rng(3)
    qkv = rng.normal(size=(2, H, W, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(nh, ws * ws, ws * ws)).astype(np.float32)
    g = rng.normal(size=(2, H, W, C)).astype(np.float32)
    labels = shifted_window_region_labels(H, W, ws, ws // 2) if shifted else None
    scale = hd ** -0.5

    tq = torch.tensor(qkv, requires_grad=True)
    tb = torch.tensor(bias, requires_grad=True)
    out = ac.WindowAttentionFunction.apply(
        tq, tb, None if labels is None else torch.from_numpy(labels), ws, scale)
    out.backward(torch.from_numpy(g))

    mask = None
    if shifted:
        pair = np.where(labels[:, None, :] != labels[:, :, None], -100.0, 0.0)
        mask = jnp.asarray(np.tile(pair.astype(np.float32), (2, 1, 1)))
    gq, gk, gv = (jnp.asarray(t) for t in
                  _partition_np(g.reshape(2, H, W, 1, C).repeat(3, 3)
                                .reshape(2, H, W, 3 * C), ws, nh))
    q, k, v = (jnp.asarray(t) for t in _partition_np(qkv, ws, nh))

    def f(q, k, v, b):
        return jnp.sum(_reference_core(q, k, v, b, mask, scale) * gq)

    dq, dk, dv, db = jax.grad(f, argnums=(0, 1, 2, 3))(q, k, v, jnp.asarray(bias))
    pq, pk, pv = _partition_np(tq.grad.numpy(), ws, nh)
    for got, want in ((pq, dq), (pk, dk), (pv, dv), (tb.grad.numpy(), db)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_b1_backward_matches_flax_attention_block(monkeypatch):
    """The port's WindowAttention with its core run through B1's Function,
    against jax.grad of the flax block (which packs windows into 128-token
    tiles): gradients of the input and of every parameter."""
    ws, hd, nh = 4, 16, 4
    C, H, W = nh * hd, 2 * ws, 4 * ws
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, H, W, C)).astype(np.float32)
    g = rng.normal(size=(2, H, W, C)).astype(np.float32)
    labels = shifted_window_region_labels(H, W, ws, ws // 2)
    p = {
        "qkv": {"kernel": rng.normal(0, 0.2, (C, 3 * C)).astype(np.float32),
                "bias": rng.normal(0, 0.1, 3 * C).astype(np.float32)},
        "proj": {"kernel": rng.normal(0, 0.2, (C, C)).astype(np.float32),
                 "bias": rng.normal(0, 0.1, C).astype(np.float32)},
        "relative_position_bias_table": rng.normal(
            size=((2 * ws - 1) ** 2, nh)).astype(np.float32),
    }
    jm = JaxWindowAttention(dim=C, window_size=(ws, ws), num_heads=nh)

    def f(params, xx):
        return jnp.sum(jm.apply({"params": params}, xx, labels=labels) * g)

    jp, jx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))

    calls = []

    def through_function(*a):
        calls.append(1)
        return ac.WindowAttentionFunction.apply(*a)

    monkeypatch.setattr(port_win_attention, "window_attention", through_function)
    port = WindowAttention(C, (ws, ws), nh)
    port.load_state_dict({
        "qkv.weight": torch.tensor(p["qkv"]["kernel"].T),
        "qkv.bias": torch.tensor(p["qkv"]["bias"]),
        "proj.weight": torch.tensor(p["proj"]["kernel"].T),
        "proj.bias": torch.tensor(p["proj"]["bias"]),
        "relative_position_bias_table": torch.tensor(
            p["relative_position_bias_table"]),
    })
    tx = torch.tensor(x, requires_grad=True)
    (port(tx, torch.from_numpy(labels)) * torch.from_numpy(g)).sum().backward()
    assert calls
    pairs = [
        (tx.grad.numpy(), jx),
        (port.qkv.weight.grad.numpy().T, jp["qkv"]["kernel"]),
        (port.qkv.bias.grad.numpy(), jp["qkv"]["bias"]),
        (port.proj.weight.grad.numpy().T, jp["proj"]["kernel"]),
        (port.relative_position_bias_table.grad.numpy(),
         jp["relative_position_bias_table"]),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_b1_function_takes_labels_made_in_inference_mode():
    """The codec makes (and caches) a map size's shift labels inside
    inference mode; a training step on the same size saves them for B1's
    backward, which autograd refuses for an inference tensor."""
    from stf_tpu_torch.layers import region_labels

    with torch.inference_mode():
        labels = region_labels(8, 12, 4, 2, torch.device("cpu"))
    assert not labels.is_inference()
    qkv = torch.randn(1, 8, 12, 3 * 32, requires_grad=True)
    bias = torch.randn(2, 16, 16, requires_grad=True)
    ac.WindowAttentionFunction.apply(qkv, bias, labels, 4, 0.25).sum().backward()
    assert qkv.grad is not None and bias.grad is not None
