"""The port's layers against the JAX modules at the same weights (f32,
atol = rtol = 1e-5: the two frameworks' CPU convolutions and matmuls sum
in different orders, which moves f32 results by ~1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu.layers import GDN as JaxGDN
from stf_tpu.layers import Conv, ConvTranspose
from stf_tpu.layers import Win_noShift_Attention as JaxWinNoShift
from stf_tpu.layers import subpel_conv3x3 as jax_subpel
from stf_tpu.layers.win_attention import ResidualUnit as JaxResidualUnit
from stf_tpu_torch.layers import GDN, ResidualUnit, Win_noShift_Attention
from stf_tpu_torch.layers import conv, deconv, subpel_conv3x3
from stf_tpu_torch.zoo.jax_import import (
    conv_kernel_to_torch,
    deconv_kernel_to_torch,
    state_dict_from_jax,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _init(module, x, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, module.init(jax.random.key(seed), jnp.asarray(x))["params"]
    )


def _port(module, x_nhwc):
    with torch.no_grad():
        y = module(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


def _load_conv(layer, p):
    layer.load_state_dict({
        "weight": torch.tensor(conv_kernel_to_torch(p["kernel"])),
        "bias": torch.tensor(p["bias"]),
    })


@pytest.mark.parametrize("k,s,n", [(5, 2, 16), (3, 1, 16), (5, 2, 17)])
def test_conv(k, s, n):
    x = _x((2, n, n, 4), 0)
    jm = Conv(6, kernel_size=k, stride=s)
    p = _init(jm, x)
    layer = conv(4, 6, k, s)
    _load_conv(layer, p["Conv_0"])
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    np.testing.assert_allclose(_port(layer, x), want, **TOL)


def test_conv_transpose():
    x = _x((2, 8, 8, 5), 1)
    jm = ConvTranspose(6, kernel_size=5, stride=2)
    p = _init(jm, x)["ConvTranspose_0"]
    layer = deconv(5, 6, 5, 2)
    layer.load_state_dict({
        "weight": torch.tensor(deconv_kernel_to_torch(p["kernel"])),
        "bias": torch.tensor(p["bias"]),
    })
    want = np.asarray(jm.apply({"params": {"ConvTranspose_0": p}}, jnp.asarray(x)))
    assert want.shape == (2, 16, 16, 6)
    np.testing.assert_allclose(_port(layer, x), want, **TOL)


def test_subpel_conv3x3():
    x = _x((2, 6, 6, 8), 2)
    jm = jax_subpel(5, 2)
    p = _init(jm, x)
    layer = subpel_conv3x3(8, 5, 2)
    _load_conv(layer[0], p["Conv_0"]["Conv_0"])
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    np.testing.assert_allclose(_port(layer, x), want, **TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn(inverse):
    C = 12
    x = _x((2, 6, 6, C), 3)
    rng = np.random.default_rng(4)
    p = {
        "beta": (1.0 + 0.3 * rng.random(C)).astype(np.float32),
        "gamma": (0.1 * rng.random((C, C)) + 0.02).astype(np.float32),
    }
    jm = JaxGDN(C, inverse=inverse)
    layer = GDN(C, inverse=inverse)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    np.testing.assert_allclose(_port(layer, x), want, **TOL)


def test_residual_unit():
    x = _x((2, 8, 8, 16), 5)
    jm = JaxResidualUnit(16)
    p = _init(jm, x)
    layer = ResidualUnit(16)
    for c, seq in (("Conv_0", 0), ("Conv_1", 2), ("Conv_2", 4)):
        _load_conv(layer.conv[seq], p[c]["Conv_0"])
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    np.testing.assert_allclose(_port(layer, x), want, **TOL)


@pytest.mark.parametrize("dim,heads,ws,ss,hw", [
    (16, 2, 4, 2, (8, 12)),   # shifted 4x4 windows
    (32, 4, 8, 4, (16, 16)),  # shifted 8x8 windows
])
def test_win_noshift_attention(dim, heads, ws, ss, hw):
    x = _x((2, *hw, dim), 6)
    jm = JaxWinNoShift(dim=dim, num_heads=heads, window_size=ws, shift_size=ss)
    p = _init(jm, x, seed=7)
    # a random bias table (flax initialises it near zero)
    table = p["win_attn"]["attn"]["relative_position_bias_table"]
    p["win_attn"]["attn"]["relative_position_bias_table"] = _x(table.shape, 8)
    sd = state_dict_from_jax({"g_a": {"attn_0": p}})
    layer = Win_noShift_Attention(dim, heads, ws, ss)
    layer.load_state_dict(
        {k[len("g_a.4."):]: v for k, v in sd.items()}, strict=True
    )
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    np.testing.assert_allclose(_port(layer, x), want, **TOL)


def test_ops_values_and_gradients_match_jax():
    """LowerBound's pass-through-if gradient, ste_round's identity
    gradient and the GDN reparametrizer, against the JAX ops."""
    from stf_tpu.ops import NonNegativeParametrizer as JaxReparam
    from stf_tpu.ops import lower_bound as jax_lower_bound
    from stf_tpu.ops import ste_round as jax_ste_round
    from stf_tpu_torch.ops import NonNegativeParametrizer, lower_bound, ste_round

    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, 64).astype(np.float32)
    g = rng.normal(0, 1, 64).astype(np.float32)  # upstream grads, both signs
    ours, theirs = NonNegativeParametrizer(1e-6), JaxReparam(1e-6)
    cases = [
        (lambda t: lower_bound(t, 0.1), lambda a: jax_lower_bound(a, 0.1)),
        (ste_round, jax_ste_round),
        (ours, theirs),
    ]
    for port_fn, jax_fn in cases:
        xt = torch.tensor(x, requires_grad=True)
        yt = port_fn(xt)
        (yt * torch.tensor(g)).sum().backward()
        yj, vjp = jax.vjp(jax_fn, jnp.asarray(x))
        np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), **TOL)
        np.testing.assert_allclose(
            xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), **TOL
        )
