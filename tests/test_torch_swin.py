"""The port's Swin layers against the JAX modules at the same weights (f32,
atol = rtol = 1e-5: the two frameworks' CPU matmuls and convolutions sum
in different orders, and flax's LayerNorm takes the variance as
E[x^2] - E[x]^2 where torch's subtracts the mean first, which moves
results by ~1e-6).

Every leaf is drawn at random from a seeded numpy generator, the
LayerNorms' scales and biases away from 1 and 0 and the relative-position
tables at a scale where they matter, then carried to the port through
`state_dict_from_jax(..., model)` under the model's own paths, so the
weight bridge's rules are exercised leaf by leaf. STF's layers at head
width 16 and window 4; TBC's stages at its 8x8 windows and head widths
6 and 10 and its hyper stacks' 4x4 / 6; DYSTF's token-routing layers
and CC_GD's gate; maps that need padding to the window."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu.layers import swin as jswin
from stf_tpu.models import cc_gd as jcc_gd
from stf_tpu.models import dystf as jdystf
from stf_tpu_torch.layers import swin
from stf_tpu_torch.models import cc_gd, dystf
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
        if name == "scale" or name == "gate":
            v = 1 + rng.uniform(-0.5, 0.5, shape)
        elif name == "bias" and len(shape) == 1:
            v = rng.uniform(-0.5, 0.5, shape)
        elif name == "relative_position_bias_table":
            v = rng.normal(0, 0.5, shape)
        elif name == "mask":
            v = rng.uniform(size=shape) < 0.6
        else:  # dense and conv kernels, He-normal
            v = rng.normal(0, np.sqrt(2 / np.prod(shape[:-1])), shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


def _pair(jax_module, port_module, x_jax, flax_prefix, torch_prefix, seed=0,
          model="stf", args=()):
    """(JAX output, port module loaded with the same weights): the flax
    params, wrapped under `flax_prefix` (the module's path in the registry
    model `model`), go through `state_dict_from_jax`, and `torch_prefix`
    is stripped from the keys. `args` follow x in the JAX call."""
    template = jax.eval_shape(
        lambda: jax_module.init(jax.random.key(0), jnp.asarray(x_jax), *args)
    )["params"]
    params = _random_params(template, seed)
    want = jax.jit(lambda p, x: jax_module.apply({"params": p}, x, *args))(
        params, jnp.asarray(x_jax))
    want = jax.tree_util.tree_map(np.asarray, want)
    tree = params
    for part in reversed(flax_prefix.split("/")):
        tree = {part: tree}
    sd = state_dict_from_jax(tree, model)
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


@pytest.mark.parametrize("direction", ["merge_rgb", "split_rgb"])
def test_patch_resampling_to_a_chosen_width(direction):
    """TBC's first PatchMerging (raw RGB: LN(12), 12 -> 16, no bias) on
    an odd map, and its last PatchSplit (16 -> 4 * 3, to RGB)."""
    if direction == "merge_rgb":
        x = _x((2, 7, 9, 3), 6)
        want, m = _pair(jswin.PatchMerging(dim=3, out_features=16),
                        swin.PatchMerging(3, 16), x, "ana/stage_0/downsample",
                        "layers.0.downsample.", model="tbc")
        assert want.shape == (2, 4, 5, 16)
    else:
        x = _x((2, 5, 6, 16), 7)
        want, m = _pair(jswin.PatchSplit(dim=16, out_features=3),
                        swin.PatchSplit(16, 3), x, "syn/stage_3/upsample",
                        "syn_layers.3.downsample.", model="tbc")
        assert want.shape == (2, 10, 12, 3)
    assert m.reduction.bias is None
    np.testing.assert_allclose(_nhwc(m, x), want, **TOL)


# (JAX stage, port stage, flax path, torch prefix, input shape): TBC's
# analysis stage at head width 6, its synthesis stage at 10 (both 8x8
# windows, 4 heads), and its hyper analysis and synthesis stages at 4x4
# windows and head width 6
TBC_STAGES = {
    "merge_first_hd6": (
        jswin.MergeFirstLayer(dim_in=16, dim_out=24, depth=2, num_heads=4,
                              window_size=8),
        swin.MergeFirstLayer(16, 24, 2, 4, 8), "ana/stage_1", "layers.1.",
        (2, 18, 22, 16)),
    "split_last_hd10": (
        jswin.SplitLastLayer(dim=40, dim_out=32, depth=2, num_heads=4,
                             window_size=8),
        swin.SplitLastLayer(40, 32, 2, 4, 8), "syn/stage_0", "syn_layers.0.",
        (2, 5, 7, 40)),
    "hyper_merge_first": (
        jswin.MergeFirstLayer(dim_in=40, dim_out=24, depth=2, num_heads=4,
                              window_size=4),
        swin.MergeFirstLayer(40, 24, 2, 4, 4), "h_a/stage_0", "h_a.0.",
        (2, 10, 6, 40)),
    "hyper_split_last": (
        jswin.SplitLastLayer(dim=24, dim_out=40, depth=2, num_heads=4,
                             window_size=4),
        swin.SplitLastLayer(24, 40, 2, 4, 4), "h_scale_s/stage_1",
        "h_scale_s.1.", (2, 3, 5, 24)),
}


@pytest.mark.parametrize("stage", list(TBC_STAGES))
def test_tbc_stages(stage):
    """Two blocks (unshifted, then shifted) on maps that pad to the
    window, after a PatchMerging or before a PatchSplit."""
    jm, pm, flax_path, torch_prefix, shape = TBC_STAGES[stage]
    x = _x(shape, 8)
    want, m = _pair(jm, pm, x, flax_path, torch_prefix, model="tbc")
    np.testing.assert_allclose(_nhwc(m, x), want, **TOL)


def test_dystf_predictor_and_fast_mlp():
    tokens = _x((2, 20, 32), 9)
    want, m = _pair(jdystf.PredictorLG(dim=32), dystf.PredictorLG(32), tokens,
                    "layer_2/predictor_1", "layers.2.score_predictor.1.",
                    model="dystf")
    assert want.shape == (2, 20, 2)
    np.testing.assert_allclose(_nhwc(m, tokens), want, **TOL)
    want, m = _pair(jdystf.FastMlp(dim=32), dystf.FastMlp(32), tokens,
                    "layer_2/block_3/fastmlp", "layers.2.blocks.3.fastmlp.",
                    model="dystf")
    np.testing.assert_allclose(_nhwc(m, tokens), want, **TOL)


@pytest.mark.parametrize("shift", [0, 2], ids=["unshifted", "shifted"])
def test_dystf_routed_block(shift):
    """The eval routing block on a 6x10 map (padded to 8x12 for its
    attention): the same (keep, drop) split, 45 of 60 tokens kept, through
    the MLP and the fast MLP and scattered back."""
    H, W = 6, 10
    tokens = _x((2, H * W, 32), 10)
    order = np.stack([np.random.default_rng(s).permutation(H * W)
                      for s in (1, 2)])
    keep, drop = order[:, :45], order[:, 45:]
    want, m = _pair(
        jdystf.AdaSwinTransformerBlock(dim=32, num_heads=2, window_size=4,
                                       shift_size=shift),
        dystf.AdaSwinTransformerBlock(32, 2, 4, shift_size=shift), tokens,
        "layer_1/block_1", "layers.1.blocks.1.", model="dystf",
        args=(H, W, (jnp.asarray(keep), jnp.asarray(drop)), False),
    )
    with torch.no_grad():
        got = m(torch.from_numpy(tokens), H, W,
                (torch.from_numpy(keep), torch.from_numpy(drop))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_dystf_stage_with_two_pruning_steps():
    """A DyBasicLayer of depth 4 pruning at blocks 1 (0.75) and 3 (0.5),
    then PatchMerging, as the JAX stage runs it: the map and the decisions
    (keep and drop token indexes, in order)."""
    x = _x((2, 8, 8, 32), 11)
    steps = [(1, 0, 0.75), (3, 1, 0.5)]
    jm = jdystf.DyBasicLayer(dim=32, depth=4, num_heads=2, window_size=4,
                             merge=True, pruning_locs=(1, 3),
                             sparse_ratio=(0.75, 0.5), n_predictors=2)
    want, m = _pair(jm, dystf.DyBasicLayer(32, 4, 2, 4, merge=True,
                                           steps=steps, first_routed=1),
                    x, "layer_2", "layers.2.", model="dystf")
    decisions = []
    with torch.no_grad():
        got = m(torch.from_numpy(x), decisions=decisions).numpy()
    np.testing.assert_allclose(got, want[0], **TOL)
    assert len(decisions) == len(want[1]) == 2
    for (gk, gd), (wk, wd) in zip(decisions, want[1]):
        assert gk.shape[1] in (48, 32)
        np.testing.assert_array_equal(gk.numpy(), wk)
        np.testing.assert_array_equal(gd.numpy(), wd)


def test_cc_gd_gate_decorator():
    """x * gate * mask over the channels, with a mask holding zeros; the
    port's gate and mask are (1, C, 1, 1) on NCHW maps."""
    x = _x((2, 5, 6, 24), 12)
    want, m = _pair(jcc_gd.GateDecorator(channels=24),
                    cc_gd.GateDecorator(24), x, "h_a/gate_1", "h_a.4.",
                    model="cc_gd")
    assert m.gate.shape == m.mask.shape == (1, 24, 1, 1)
    assert 0 < int((m.mask == 0).sum()) < 24
    with torch.no_grad():
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


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
