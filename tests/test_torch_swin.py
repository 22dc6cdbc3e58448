"""The port's Swin layers against the JAX modules at the same weights (f32,
atol = rtol = 1e-5: the two frameworks' CPU matmuls and convolutions sum
in different orders, and flax's LayerNorm takes the variance as
E[x^2] - E[x]^2 where torch's subtracts the mean first, which moves
results by ~1e-6).

Every leaf is drawn at random from a seeded numpy generator, the
LayerNorms' scales and biases away from 1 and 0 and the relative-position
tables at a scale where they matter, then carried to the port through
`state_dict_from_jax(..., "stf")` under the STF model's own paths, so the
weight bridge's rules are exercised leaf by leaf. Head width 16 and
window 4 as in the STF model; maps that need padding to the window."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stf_tpu.layers import swin as jswin
from stf_tpu_torch.layers import swin
from stf_tpu_torch.zoo import state_dict_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _random_params(template, seed):
    """A tree shaped like `template` with every leaf drawn anew."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "scale":
            v = 1 + rng.uniform(-0.5, 0.5, shape)
        elif name == "bias" and len(shape) == 1:
            v = rng.uniform(-0.5, 0.5, shape)
        elif name == "relative_position_bias_table":
            v = rng.normal(0, 0.5, shape)
        else:  # dense and conv kernels, He-normal
            v = rng.normal(0, np.sqrt(2 / np.prod(shape[:-1])), shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


def _pair(jax_module, port_module, x_jax, flax_prefix, torch_prefix, seed=0):
    """(JAX output, port module loaded with the same weights): the flax
    params, wrapped under `flax_prefix` (the module's path in the STF
    model), go through `state_dict_from_jax`, and `torch_prefix` is
    stripped from the keys."""
    template = jax.eval_shape(
        lambda: jax_module.init(jax.random.key(0), jnp.asarray(x_jax))
    )["params"]
    params = _random_params(template, seed)
    want = np.asarray(jax_module.apply({"params": params}, jnp.asarray(x_jax)))
    tree = params
    for part in reversed(flax_prefix.split("/")):
        tree = {part: tree}
    sd = state_dict_from_jax(tree, "stf")
    sd = {k[len(torch_prefix):]: v for k, v in sd.items()}
    port_module.load_state_dict(sd, strict=True)
    return want, port_module.eval()


def _nhwc(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("shift", [0, 2], ids=["unshifted", "shifted"])
def test_swin_block_on_a_map_that_needs_padding(shift):
    """6x10 pads to 8x12 after norm1; the shifted block's labels are the
    padded map's."""
    x = _x((2, 6, 10, 32), 1)
    want, block = _pair(
        jswin.SwinTransformerBlock(dim=32, num_heads=2, window_size=4,
                                   shift_size=shift),
        swin.SwinTransformerBlock(32, 2, 4, shift_size=shift),
        x, "layer_0/block_1", "layers.0.blocks.1.",
    )
    np.testing.assert_allclose(_nhwc(block, x), want, **TOL)


def test_patch_merging_on_an_odd_map():
    x = _x((2, 7, 9, 16), 2)
    want, m = _pair(jswin.PatchMerging(dim=16), swin.PatchMerging(16), x,
                    "layer_0/downsample", "layers.0.downsample.")
    assert want.shape == (2, 4, 5, 32)
    np.testing.assert_allclose(_nhwc(m, x), want, **TOL)


def test_patch_split():
    x = _x((2, 5, 6, 32), 3)
    want, m = _pair(jswin.PatchSplit(dim=32), swin.PatchSplit(32), x,
                    "syn_layer_0/upsample", "syn_layers.0.downsample.")
    assert want.shape == (2, 10, 12, 16)
    np.testing.assert_allclose(_nhwc(m, x), want, **TOL)


def test_patch_embed_on_an_odd_size():
    """The port's PatchEmbed takes the NCHW image and returns NHWC."""
    x = _x((2, 11, 13, 3), 4)
    want, m = _pair(jswin.PatchEmbed(patch_size=2, embed_dim=16),
                    swin.PatchEmbed(2, 16), x, "patch_embed",
                    "patch_embed.")
    assert want.shape == (2, 6, 7, 16)
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("resample", ["merge", "split"])
def test_basic_layer(resample):
    """Two blocks (unshifted, then shifted by 2) and the resampler, on a
    6x10 map."""
    x = _x((2, 6, 10, 32), 5)
    prefix = {"merge": ("layer_1", "layers.1."),
              "split": ("syn_layer_1", "syn_layers.1.")}[resample]
    want, layer = _pair(
        jswin.BasicLayer(dim=32, depth=2, num_heads=2, window_size=4,
                         resample=resample),
        swin.BasicLayer(32, 2, 2, 4, resample=resample), x, *prefix,
    )
    assert want.shape == ((2, 3, 5, 64) if resample == "merge"
                          else (2, 12, 20, 16))
    np.testing.assert_allclose(_nhwc(layer, x), want, **TOL)


def test_drop_path_is_the_identity_in_eval_and_raises_in_training():
    x = torch.randn(2, 4, 4, 8)
    dp = swin.DropPath(0.2).eval()
    assert dp(x) is x
    with pytest.raises(NotImplementedError):
        dp.train()(x)
    assert swin.DropPath(0.0).train()(x) is x


def test_region_labels_keep_every_table():
    """A captured CUDA graph reads its shift-region labels by address, so
    the cache never lets a table go: after tables of 300 other map sizes
    the first one made is still the one returned, with the labels of
    `shifted_window_region_labels`."""
    from stf_tpu_torch.layers import region_labels, shifted_window_region_labels

    dev = torch.device("cpu")
    first = region_labels(12, 20, 4, 2, dev)
    for h in range(1, 21):
        for w in range(1, 16):
            region_labels(4 * h, 4 * w + 400, 4, 2, dev)
    assert region_labels(12, 20, 4, 2, dev) is first
    np.testing.assert_array_equal(first.numpy(),
                                  shifted_window_region_labels(12, 20, 4, 2))
