"""Weight bridge: flax WACNN params <-> the port's state_dict."""

import numpy as np
import pytest
import torch

from _torch_port import SMALL, flat_leaves, pair_from_port
from stf_tpu.zoo.torch_import import import_state_dict
from stf_tpu.zoo.torch_import import strip_prefixes as jax_strip_prefixes
from stf_tpu_torch.models import WACNN
from stf_tpu_torch.zoo import create_model, state_dict_from_jax, strip_prefixes


@pytest.fixture(scope="module")
def params():
    return pair_from_port(seed=3)[1]


def test_jax_params_load_strict_and_round_trip(params):
    """flax -> state_dict_from_jax -> load_state_dict(strict=True) ->
    state_dict() -> stf_tpu's import_state_dict gives the original tree
    back bit for bit."""
    port = WACNN(**SMALL)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    back = import_state_dict("cnn", params, port.state_dict())
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


def test_seeded_models_are_reproducible():
    a = create_model("cnn", seed=7, **SMALL).state_dict()
    b = create_model("cnn", seed=7, **SMALL).state_dict()
    c = create_model("cnn", seed=8, **SMALL).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["g_a.0.weight"], c["g_a.0.weight"])
