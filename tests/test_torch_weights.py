"""Weight bridge: flax params <-> the port's state_dict, for the six
registry models."""

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import CONFIGS, SMALL, flat_leaves, pair_from_port
from stf_tpu.zoo.torch_import import import_state_dict
from stf_tpu.zoo.torch_import import strip_prefixes as jax_strip_prefixes
from stf_tpu_torch.models import WACNN
from stf_tpu_torch.zoo import (
    create_model,
    models,
    state_dict_from_jax,
    strip_prefixes,
)


@pytest.fixture(scope="module")
def params():
    return pair_from_port(seed=3)[1]


# keys the bridge must make for each registry name at its small config
# (`_torch_port.CONFIGS`): STF's cover LayerNorm scales, bias-free
# reductions and PatchSplit under `downsample`; TBC's its merge-first and
# split-last stacks, the hyper stacks among them; CC's GDN and IGDN and
# its ReLU stacks; CC_GD's gates and masks at Sequential 3i + 1; DYSTF's
# predictors and routed blocks' fastmlp
CASES = {
    "cnn": ("g_a.4.conv_b.0.attn.qkv.weight", "g_s.1.weight"),
    "stf": (
        "patch_embed.norm.weight", "layers.2.blocks.1.attn.qkv.weight",
        "layers.0.downsample.reduction.weight",
        "syn_layers.1.downsample.norm.bias", "end_conv.2.weight",
        "h_mean_s.6.0.weight", "lrp_transforms.3.8.bias"),
    "tbc": (
        "layers.0.downsample.reduction.weight",
        "layers.3.blocks.1.attn.relative_position_bias_table",
        "syn_layers.3.downsample.reduction.weight",
        "h_a.1.downsample.norm.weight", "h_mean_s.0.blocks.0.attn.qkv.weight",
        "h_scale_s.1.downsample.reduction.weight", "lrp_transforms.5.8.bias"),
    "cc": ("g_a.1.gamma", "g_s.5.beta", "g_s.6.weight", "h_a.4.weight",
           "h_mean_s.2.weight", "h_scale_s.4.bias",
           "cc_mean_transforms.3.4.weight"),
    "cc_gd": ("g_a.6.bias", "h_a.7.gate", "h_mean_s.4.mask",
              "h_scale_s.6.weight", "cc_scale_transforms.2.3.weight",
              "lrp_transforms.0.4.mask", "cc_mean_transforms.1.6.bias"),
    "dystf": ("layers.2.score_predictor.1.out_conv.4.weight",
              "layers.3.blocks.1.fastmlp.fc1.0.weight",
              "layers.1.blocks.1.fastmlp.fc1.1.bias", "end_conv.2.weight"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_jax_params_load_strict_and_round_trip(params, name):
    """flax -> state_dict_from_jax(params, name) -> load_state_dict(
    strict=True) -> state_dict() -> stf_tpu's import_state_dict gives the
    original tree back bit for bit, every flax leaf mapped to a key of its
    own. WACNN's call takes the default model name."""
    if name == "cnn":
        sd = state_dict_from_jax(params)
    else:
        params = pair_from_port(seed=3, name=name)[1]
        sd = state_dict_from_jax(params, name)
    if name in ("stf", "tbc"):
        assert "layers.0.downsample.reduction.bias" not in sd
    if name == "cc_gd":
        assert sd["h_a.1.gate"].shape == (1, 40, 1, 1)
    assert len(sd) == len(flat_leaves(params))
    for k in CASES[name]:
        assert k in sd, k
    port = models[name](**CONFIGS[name])
    port.load_state_dict(sd, strict=True)
    back = import_state_dict(name, params, port.state_dict())
    want, got = flat_leaves(params), flat_leaves(back)
    assert set(want) == set(got)
    for path, leaf in want.items():
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def test_key_count_matches_jax_leaves(params):
    port = WACNN(**SMALL)
    assert len(port.state_dict()) == len(flat_leaves(params))
    keys = set(port.state_dict())
    for k in ("g_a.4.conv_b.0.attn.qkv.weight", "h_mean_s.2.0.weight",
              "cc_mean_transforms.3.4.weight", "entropy_bottleneck._matrix0",
              "g_s.1.weight", "g_a.1.gamma",
              "g_s.5.conv_b.0.attn.relative_position_bias_table"):
        assert k in keys, k


def test_strip_prefixes_matches_jax_package():
    sd = {
        "module.g_a.0.weight": 1,
        "h_s.0.weight": 2,
        "module.entropy_bottleneck._biases.3": 3,
        "entropy_bottleneck._matrices.0": 4,
        "entropy_bottleneck._factors.2": 5,
    }
    assert strip_prefixes(sd) == jax_strip_prefixes(sd)


# (name, a weight every seed draws anew)
SEEDED = [("cnn", "g_a.0.weight"), ("stf", "patch_embed.proj.weight"),
          ("tbc", "layers.0.downsample.reduction.weight"),
          ("cc", "g_a.0.weight"), ("cc_gd", "h_a.0.weight"),
          ("dystf", "layers.2.score_predictor.0.in_conv.1.weight")]


@pytest.mark.parametrize("name,first", SEEDED, ids=[n for n, _ in SEEDED])
def test_seeded_models_are_reproducible(name, first):
    """create_model(name, seed=s) draws every weight from the seed and
    raises nothing; STF's at full size too, its LayerNorms at 1 and 0;
    CC_GD's gates and masks at 1."""
    cfg = CONFIGS[name]
    a = create_model(name, seed=7, **cfg).state_dict()
    b = create_model(name, seed=7, **cfg).state_dict()
    c = create_model(name, seed=8, **cfg).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[first], c[first])
    if name == "stf":
        full = create_model("stf", seed=7).state_dict()
        again = create_model("stf", seed=7).state_dict()
        assert all(torch.equal(full[k], again[k]) for k in full)
        assert torch.equal(full["layers.0.blocks.0.norm1.weight"],
                           torch.ones(48))
    if name == "cc_gd":
        assert all(torch.equal(v, torch.ones_like(v)) for k, v in a.items()
                   if k.endswith((".gate", ".mask")))
