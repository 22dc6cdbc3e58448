"""Weight bridge: flax WACNN and STF params <-> the port's state_dict."""

import numpy as np
import pytest
import torch

from _torch_port import SMALL, STF_SMALL, flat_leaves, pair_from_port
from stf_tpu.zoo.torch_import import import_state_dict
from stf_tpu.zoo.torch_import import strip_prefixes as jax_strip_prefixes
from stf_tpu_torch.models import WACNN, SymmetricalTransFormer
from stf_tpu_torch.zoo import create_model, state_dict_from_jax, strip_prefixes


@pytest.fixture(scope="module")
def params():
    return pair_from_port(seed=3)[1]


# (registry name, port class, small config, keys the bridge must make);
# STF's cover LayerNorm scales, bias-free reductions and PatchSplit
# under `downsample`
CASES = {
    "cnn": (WACNN, SMALL, ("g_a.4.conv_b.0.attn.qkv.weight", "g_s.1.weight")),
    "stf": (SymmetricalTransFormer, STF_SMALL, (
        "patch_embed.norm.weight", "layers.2.blocks.1.attn.qkv.weight",
        "layers.0.downsample.reduction.weight",
        "syn_layers.1.downsample.norm.bias", "end_conv.2.weight",
        "h_mean_s.6.0.weight", "lrp_transforms.3.8.bias")),
}


@pytest.mark.parametrize("name", list(CASES))
def test_jax_params_load_strict_and_round_trip(params, name):
    """flax -> state_dict_from_jax(params, name) -> load_state_dict(
    strict=True) -> state_dict() -> stf_tpu's import_state_dict gives the
    original tree back bit for bit, every flax leaf mapped to a key of its
    own. WACNN's call takes the default model name."""
    if name == "stf":
        params = pair_from_port(seed=3, name="stf")[1]
        sd = state_dict_from_jax(params, "stf")
        assert "layers.0.downsample.reduction.bias" not in sd
    else:
        sd = state_dict_from_jax(params)
    cls, cfg, keys = CASES[name]
    assert len(sd) == len(flat_leaves(params))
    for k in keys:
        assert k in sd, k
    port = cls(**cfg)
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


@pytest.mark.parametrize("name,first,cfg", [
    ("cnn", "g_a.0.weight", SMALL),
    ("stf", "patch_embed.proj.weight", STF_SMALL),
], ids=["cnn", "stf"])
def test_seeded_models_are_reproducible(name, first, cfg):
    """create_model(name, seed=s) draws every weight from the seed and
    raises nothing; STF's at full size too, its LayerNorms at 1 and 0."""
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
