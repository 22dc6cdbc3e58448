"""The DYSTF slice: the port's DYSTF (eval routing) and Codec against the
JAX ones at the same (imported) weights, on the CPU, for a small DYSTF at
STF's head width 16 whose schedule shows the reference's shared-list
quirk (`_torch_configs.DYSTF_SMALL`: the shared pruning offsets are (1,
1, 0), so stage 1 scores at block 0 and stages 2 and 3 at blocks 0 and
1, and the third ratio is never reached).

The pruning schedule is held against the JAX model's (which predictors
and routed blocks exist, for the defaults and the small model); the
(keep, drop) token indexes the last pruned stage chooses against the JAX
forward's `decisions`; planted score ties (every predictor's last layer
at zero) must keep JAX's order, the first n_keep tokens. Tolerances and
exactness as `_torch_family` states them.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_family as fam
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import DYSTF_SMALL, flat_leaves, jax_template, port_small
from _torch_port import to_jax
from stf_tpu.models.dystf import DYSTF as JaxDYSTF
from stf_tpu_torch.models import dystf
from stf_tpu_torch.zoo import create_model

SIZES = (64, 72)


@pytest.fixture(scope="module")
def pair():
    port = port_small(5, "dystf")
    return dict(port=port, **dict(zip(("jmodel", "params"),
                                      to_jax("dystf", port))))


def _jax_run(jmodel, params, x):
    """The JAX eval forward's outputs and its decisions as NumPy."""
    out = fam.jax_apply(jmodel)(params, x)
    return (fam.outputs(out),
            [tuple(np.asarray(i) for i in d) for d in out["decisions"]])


@pytest.fixture(scope="module")
def forwards(pair):
    """{size: (JAX forward, JAX decisions, port forward)}."""
    out = {}
    for size in SIZES:
        x = fam.images(size)
        want, decisions = _jax_run(pair["jmodel"], pair["params"], x)
        out[size] = (want, decisions, fam.port_forward(pair["port"], x))
    return out


@pytest.mark.parametrize("size", SIZES)
def test_eval_forward_matches_jax(forwards, size):
    want, _, got = forwards[size]
    fam.check_forward(got, want, size, y_ch=128, z_ch=64)


def test_eval_forward_depends_on_the_image(forwards):
    for size in SIZES:
        fam.check_depends_on_the_image(forwards[size][2])


def _port_decisions(port, x):
    with torch.no_grad():
        _, decisions = port.analysis_with_decisions(
            torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    return [tuple(i.numpy() for i in d) for d in decisions]


@pytest.mark.parametrize("size", SIZES)
def test_kept_tokens_match_jax(pair, forwards, size):
    """The last pruned stage's (keep, drop) indexes, in order: stage 3's
    two steps, keeping int(N * 0.75) and int(N * 0.5) of its tokens."""
    want = forwards[size][1]
    got = _port_decisions(pair["port"], fam.images(size))
    n = (-(-size // 16)) ** 2
    assert [d[0].shape for d in got] == [(2, int(n * 0.75)), (2, int(n * 0.5))]
    assert len(got) == len(want)
    for (gk, gd), (wk, wd) in zip(got, want):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gd, wd)


def _structure(tree_keys):
    """{stage: (predictors, blocks with a fastmlp)} from flax param paths."""
    out = {}
    for path in tree_keys:
        if path[0].startswith("layer_") and len(path) > 2:
            s = int(path[0][len("layer_"):])
            preds, fast = out.setdefault(s, (set(), set()))
            if path[1].startswith("predictor_"):
                preds.add(int(path[1][len("predictor_"):]))
            elif path[2] == "fastmlp":
                fast.add(int(path[1][len("block_"):]))
    return {s: (sorted(p), sorted(f)) for s, (p, f) in sorted(out.items())}


def _port_structure(model):
    return {s: (list(range(len(layer.score_predictor))),
                [i for i, b in enumerate(layer.blocks)
                 if isinstance(b, dystf.AdaSwinTransformerBlock)])
            for s, layer in enumerate(model.layers)}


@pytest.mark.parametrize("config", ["default", "small"])
def test_pruning_schedule_matches_jax(config):
    """Which predictors and which routed (fastmlp) blocks each stage has,
    as the JAX model's params lay them out, and for the defaults the
    reference's schedule: stage 1 scores at block 1 (0.9), stage 2 at
    blocks 1 (0.9) and 3 (0.7), stage 3 at block 1 (0.9)."""
    kwargs = {} if config == "default" else DYSTF_SMALL
    port = create_model("dystf", **kwargs)
    want = _structure(flat_leaves(jax.tree_util.tree_map(
        np.asarray, jax_template(JaxDYSTF(**kwargs)))))
    assert _port_structure(port) == want
    if config == "default":
        assert port.schedule == [
            ([], None), ([(1, 0, 0.9)], 1),
            ([(1, 0, 0.9), (3, 1, 0.7)], 1), ([(1, 0, 0.9)], 1)]
    else:
        assert port.schedule[2][0] == [(0, 0, 0.75), (1, 1, 0.5)]
        assert port.schedule[3][0] == [(0, 0, 0.75), (1, 1, 0.5)]


# -- ties and planted faults --------------------------------------------------

def _tied(port):
    """Every predictor's last Linear at zero: all its scores tie."""
    with torch.no_grad():
        for layer in port.layers:
            for p in layer.score_predictor:
                p.out_conv[4].weight.zero_()
                p.out_conv[4].bias.copy_(torch.tensor([0.3, -0.2]))
    return port


@pytest.fixture(scope="module")
def tied(pair):
    port = _tied(port_small(5, "dystf"))
    _, params = to_jax("dystf", port, model=pair["jmodel"])
    x = fam.images(64)
    want, decisions = _jax_run(pair["jmodel"], params, x)
    return dict(port=port, x=x, want=want, decisions=decisions)


def _reversed_ties(scores, ratio):
    """An ascending stable sort read backwards: ties in reverse order."""
    n_keep = int(scores.shape[1] * ratio)
    order = torch.argsort(scores, dim=1, stable=True).flip(1)
    return order[:, :n_keep], order[:, n_keep:]


def test_tied_scores_keep_jax_order(tied, monkeypatch):
    """With every score tied, JAX keeps the first n_keep tokens, and so
    does the port (forward within tolerance); a sort that reverses ties
    keeps others and misses the forward by more than tenfold."""
    got = _port_decisions(tied["port"], tied["x"])
    for (gk, gd), (wk, wd) in zip(got, tied["decisions"]):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(wk[0], np.arange(wk.shape[1]))
    assert fam.worst(fam.port_forward(tied["port"], tied["x"]),
                     tied["want"]) <= fam.FORWARD_TOL
    monkeypatch.setattr(dystf, "route", _reversed_ties)
    assert fam.worst(fam.port_forward(tied["port"], tied["x"]),
                     tied["want"]) > 10 * fam.FORWARD_TOL


def _faithful_route(scores, ratio):
    n_keep = int(scores.shape[1] * ratio)
    order = torch.argsort(-scores, dim=1, stable=True)
    return order[:, :n_keep], order[:, n_keep:]


def _one_more(scores, ratio):
    keep, drop = _faithful_route(scores, ratio)
    order = torch.cat([keep, drop], 1)
    return order[:, :keep.shape[1] + 1], order[:, keep.shape[1] + 1:]


def _swap_tails(port):
    for m in port.modules():
        if isinstance(m, dystf.AdaSwinTransformerBlock):
            m.mlp, m.fastmlp = m.fastmlp, m.mlp


@pytest.mark.parametrize("fault", ["faithful", "keep_one_more",
                                   "mlp_and_fastmlp_swapped"])
def test_eval_forward_comparison_catches_planted_faults(pair, forwards,
                                                        monkeypatch, fault):
    port = pair["port"]
    if fault == "mlp_and_fastmlp_swapped":
        worst = fam.planted(port, _swap_tails, fam.images(72), forwards[72][0])
    else:
        routes = {"faithful": _faithful_route, "keep_one_more": _one_more}
        monkeypatch.setattr(dystf, "route", routes[fault])
        worst = fam.worst(fam.port_forward(port, fam.images(72)),
                          forwards[72][0])
    if fault == "faithful":
        assert worst <= fam.FORWARD_TOL, worst
    else:
        assert worst > 10 * fam.FORWARD_TOL, worst


def test_training_branch_raises(pair):
    x = torch.from_numpy(fam.images(64))
    with pytest.raises(NotImplementedError, match="dytrain"):
        pair["port"](x, training=True, sampler=object())
    model = create_model("dystf", **DYSTF_SMALL).train()
    with pytest.raises(NotImplementedError, match="dytrain"):
        model.analysis(x.permute(0, 3, 1, 2))


# -- the codec ----------------------------------------------------------------

@pytest.fixture(scope="module")
def codecs(pair):
    return fam.codecs(pair["jmodel"], pair["params"], pair["port"])


def test_indexes_and_streams_match_jax(codecs):
    fam.check_streams_match_jax(codecs, 4, [32] * 4)


def test_cross_decoding(codecs):
    fam.check_cross_decoding(codecs)


def test_lane_and_host_round_trips_agree(codecs):
    fam.check_lane_and_host(codecs)


@pytest.mark.parametrize("tier", [True, "split"], ids=str)
def test_fused_encode_tiers_give_the_per_slice_stream(codecs, tier):
    fam.check_tier(codecs, tier)
