"""The CC and CC_GD slices: the port's CC and CC_GD and the Codec against
the JAX ones at the same (imported) weights, on the CPU, at the small
size of tests/test_lane_codec.py (N=32, M=40, 4 slices of 10, 2 of them
as support; the hyper stacks' middle width 32).

CC_GD's gates and masks are drawn at random, the masks with a third of
their channels at 0: at their init (all ones) a gate read from the wrong
index would go unseen. Also: a CC_GD built from a CC's state_dict
(`init_cc_gd_from_cc`) computes what the CC does, bit for bit, and holds
the state JAX's `init_cc_gd_from_cc` makes; the ungated `deps` build at
pruned widths (z of 16 channels) against JAX's `CC_GD(deps=...)`.
Tolerances and exactness as `_torch_family` states them.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_family as fam
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import SMALL, flat_leaves, jax_template, port_small, to_jax
from stf_tpu.models.cc_gd import CC_GD as JaxCC_GD
from stf_tpu.models.cc_gd import init_cc_gd_from_cc as jax_init_from_cc
from stf_tpu_torch.layers import GDN
from stf_tpu_torch.models import CC_GD, init_weights
from stf_tpu_torch.models.cc_gd import GateDecorator, init_cc_gd_from_cc
from stf_tpu_torch.zoo import state_dict_from_jax

from _torch_scale import he_scale, random_gates

SIZE = 64
# pruned widths of a `deps` build (the analog of a prune export's .deps.json)
DEPS = {"h_a/gate_0": 28, "h_a/gate_1": 20, "h_a/gate_2": 16,
        "h_mean_s/gate_0": 24, "h_mean_s/gate_1": 18, "h_mean_s/gate_2": 36,
        "h_scale_s/gate_0": 22, "h_scale_s/gate_1": 30, "h_scale_s/gate_2": 40,
        "cc_mean_1/gate_0": 150, "cc_scale_2/gate_1": 96, "lrp_3/gate_0": 200,
        "lrp_0/gate_1": 64}


def _pair(name, port, **kwargs):
    jmodel, params = to_jax(name, port, **kwargs)
    return dict(jmodel=jmodel, params=params, port=port)


@pytest.fixture(scope="module", params=["cc", "cc_gd"])
def pair(request):
    name = request.param
    port = port_small(7, name)
    if name == "cc_gd":
        random_gates(port, 8)
    return dict(name=name, **_pair(name, port))


@pytest.fixture(scope="module")
def forwards(pair):
    x = fam.images(SIZE)
    return (fam.jax_forward(pair["jmodel"], pair["params"], x),
            fam.port_forward(pair["port"], x))


def test_eval_forward_matches_jax(forwards):
    want, got = forwards
    fam.check_forward(got, want, SIZE, y_ch=40, z_ch=32)
    fam.check_depends_on_the_image(got)


def test_gates_and_masks_are_random(pair):
    """cc_gd: some masks hold zeros, no gate is at 1."""
    gates = [m for m in pair["port"].modules() if isinstance(m, GateDecorator)]
    assert bool(gates) == (pair["name"] == "cc_gd")
    if gates:
        assert len(gates) == 3 + 3 + 3 + 3 * 4 * 2
        masks = torch.cat([m.mask.flatten() for m in gates])
        assert 0.2 < (masks == 0).float().mean() < 0.5
        assert all((m.gate != 1).all() for m in gates)


def _relu_as_gelu(port):
    for i, m in enumerate(port.h_a):
        if isinstance(m, torch.nn.ReLU):
            port.h_a[i] = torch.nn.GELU()


def _igdn_as_gdn(port):
    for m in port.g_s.modules():
        if isinstance(m, GDN):
            m.inverse = False


def _mask_ignored(port):
    for m in port.modules():
        if isinstance(m, GateDecorator):
            m.forward = (lambda self, x: x * self.gate).__get__(m)


def _gate_faithful(port):
    for m in port.modules():
        if isinstance(m, GateDecorator):
            m.forward = (lambda self, x: x * self.gate * self.mask).__get__(m)


FAULTS = {
    "cc": {"faithful": lambda port: None, "hyper_relu_as_gelu": _relu_as_gelu,
           "igdn_as_gdn": _igdn_as_gdn},
    "cc_gd": {"faithful": _gate_faithful, "mask_ignored": _mask_ignored,
              "igdn_as_gdn": _igdn_as_gdn},
}


@pytest.mark.parametrize("fault", ["faithful", "first", "second"])
def test_eval_forward_comparison_catches_planted_faults(pair, forwards, fault):
    """Two planted faults a family, each more than tenfold outside the
    forward tolerance; the fault-free control within it."""
    faults = FAULTS[pair["name"]]
    key = {"faithful": "faithful", "first": list(faults)[1],
           "second": list(faults)[2]}[fault]
    worst = fam.planted(pair["port"], faults[key], fam.images(SIZE),
                        forwards[0])
    print(f"{pair['name']} {key}: worst {worst:.3g}")
    if key == "faithful":
        assert worst <= fam.FORWARD_TOL, worst
    else:
        assert worst > 10 * fam.FORWARD_TOL, worst


# -- the codec ----------------------------------------------------------------

@pytest.fixture(scope="module")
def codecs(pair):
    return fam.codecs(pair["jmodel"], pair["params"], pair["port"])


def test_indexes_and_streams_match_jax(codecs):
    fam.check_streams_match_jax(codecs, 4, [10] * 4)


def test_cross_decoding(codecs):
    fam.check_cross_decoding(codecs)


def test_lane_and_host_round_trips_agree(codecs):
    fam.check_lane_and_host(codecs)


@pytest.mark.parametrize("tier", [True, "split"], ids=str)
def test_fused_encode_tiers_give_the_per_slice_stream(codecs, tier):
    fam.check_tier(codecs, tier)


# -- CC_GD from a CC, and the pruned-width build ----------------------------

def test_cc_gd_from_cc_computes_what_the_cc_does():
    """init_cc_gd_from_cc on the port's state_dicts: the gated model's
    forward is the CC's bit for bit (gates and masks at one), and its
    state is what JAX's init_cc_gd_from_cc makes of the same CC."""
    cc = port_small(9, "cc")
    gd = CC_GD(**SMALL).eval()
    state = init_cc_gd_from_cc(cc.state_dict(), gd.state_dict())
    gd.load_state_dict(state, strict=True)
    x = torch.from_numpy(fam.images(SIZE))
    with torch.no_grad():
        want, got = cc(x), gd(x)
    assert torch.equal(got["x_hat"], want["x_hat"])
    for k in ("y", "z"):
        assert torch.equal(got["likelihoods"][k], want["likelihoods"][k])

    _, cc_params = to_jax("cc", cc)
    # JAX's takes a CC_GD tree as flax's init makes it: gates and masks at 1
    init = jax.tree_util.tree_map_with_path(
        lambda path, a: np.ones_like(a) if path[-1].key in ("gate", "mask")
        else a, jax_template(JaxCC_GD(**SMALL)))
    jax_state = state_dict_from_jax(jax_init_from_cc(cc_params, init), "cc_gd")
    assert jax_state.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(jax_state[k], v), k
    with pytest.raises(KeyError):
        init_cc_gd_from_cc({"h_a.6.weight": torch.zeros(1)}, gd.state_dict())


@pytest.fixture(scope="module")
def deps_pair():
    gen = torch.Generator().manual_seed(12)
    port = init_weights(CC_GD(deps=DEPS, **SMALL), gen)
    port = he_scale(port, gen, "cc_gd").eval()
    jmodel = JaxCC_GD(deps=tuple(sorted(DEPS.items())), **SMALL)
    return _pair("cc_gd", port, model=jmodel)


def test_deps_build_matches_jax(deps_pair):
    """The ungated build at the DEPS widths: no gate anywhere, the convs
    at their gated positions, z of h_a/gate_2's 16 channels, the eval
    forward within tolerance of JAX's CC_GD(deps=...), and the per-slice
    lane stream byte for byte."""
    port = deps_pair["port"]
    assert not any(isinstance(m, GateDecorator) for m in port.modules())
    sd = port.state_dict()
    assert sd["h_a.6.weight"].shape[0] == 16 and "h_a.1.gate" not in sd
    assert sd["cc_mean_transforms.1.0.weight"].shape[:2] == (150, 36 + 10)
    assert len(sd) == len(flat_leaves(deps_pair["params"]))
    x = fam.images(SIZE)
    fam.check_forward(fam.port_forward(port, x),
                      fam.jax_forward(deps_pair["jmodel"],
                                      deps_pair["params"], x),
                      SIZE, y_ch=40, z_ch=16)
    c = fam.codecs(deps_pair["jmodel"], deps_pair["params"], port)
    fam.check_streams_match_jax(c, 4)
    assert port.entropy_bottleneck.medians().shape == (16,)
