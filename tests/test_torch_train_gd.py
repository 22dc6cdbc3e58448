"""CC_GD's gate-decorator pruning (`stf_tpu_torch.training.train_gd`)
against the JAX package's `stf_tpu/training/train_gd.py` on the CPU, at
the same weights, batch and quantization noise.

The model is the small CC_GD of tests/test_torch_cc.py (N=32, M=40, 4
slices) with gates drawn from U(0.5, 1.5) and a third of its channels
masked (`_torch_scale.random_gates`). The JAX steps are the CLI's
closures (`train_gd.py:342-358` the tock step, `:369-377` the tick's
gradient) fed the port's recorded noise (`_torch_replay`).

Tolerances: loss terms rel 1e-5 and each gradient within 2e-4 of its
tensor's largest JAX gradient (as the RD step's,
tests/test_torch_train.py); the tick's Taylor scores, |grad * gate|,
within 2e-4 of each gate's largest JAX score. `prune_masks` on shared
scores, `param_scale` and the exported tensors and deps exactly; the
reloaded pruned model's forward within FORWARD_TOL of JAX's and its lane
stream byte for byte; against the gated model (z's gate unmasked) within
1e-5 (folding a gate into its conv rounds once more).
"""

import copy
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import optax
import pytest
import torch

import _torch_family as fam
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import SMALL, port_small, to_jax
from _torch_replay import RecordingSampler, replay_draws
from _torch_scale import random_gates
from stf_tpu.training import train_gd as jgd
from stf_tpu.training.losses import rate_distortion_loss as jax_rd_loss
from stf_tpu.training.state import configure_optimizers
from stf_tpu_torch.models import CC_GD
from stf_tpu_torch.models.cc_gd import GateDecorator
from stf_tpu_torch.training import (
    Sampler,
    TrainState,
    accumulate_scores,
    iter_gates,
    load_pruned_checkpoint,
    make_gate_optimizer,
    make_gd_train_step,
    param_scale,
    prune_export,
    prune_masks,
)
from stf_tpu_torch.training import train_gd
from stf_tpu_torch.zoo import state_dict_from_jax

LMBDA = 0.013
SPARSE = 0.01  # large enough that the L1 term shows in the gates' gradients
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4  # of each tensor's largest JAX gradient
PARAM_RTOL = 2.5e-7  # two f32 ulps
SEED = 11


@pytest.fixture(scope="module")
def pair():
    port = random_gates(port_small(7, "cc_gd"), 8)
    jmodel, params = to_jax("cc_gd", port)
    return SimpleNamespace(port=port, jmodel=jmodel, params=params,
                           x=fam.images(64))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(scores):
    """JAX's {path tuple: score} as {"<stack>/gate_<i>": score}."""
    return {"/".join(k): np.asarray(v) for k, v in scores.items()}


def _bad_gradients(port_grads, jax_grads):
    want = state_dict_from_jax(jax_grads, "cc_gd")
    want = {k: v for k, v in want.items() if not k.endswith(".mask")}
    assert set(want) == set(port_grads), set(want) ^ set(port_grads)
    return {k: ((port_grads[k] - w).abs().max().item(), w.abs().max().item())
            for k, w in want.items()
            if not (port_grads[k] - w).abs().max().item()
            <= GRAD_TOL * w.abs().max().item()}


# -- the tock step ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tock(pair):
    """One port tock step (RD + SPARSE * L1 + aux) and the JAX CLI's step
    at the same noise: losses, gradients, states after the update."""
    port = copy.deepcopy(pair.port)
    masks = {p: g.mask.clone() for p, g in iter_gates(port)}
    state = TrainState(port, "cpu", seed=SEED)
    rec = state.sampler = RecordingSampler(state.sampler)
    grads = {}
    update = state.apply_gradients

    def apply_gradients():
        grads.update({n: p.grad.clone() for n, p in port.named_parameters()})
        update()

    state.apply_gradients = apply_gradients
    metrics = make_gd_train_step(port, LMBDA, SPARSE)(
        state, torch.from_numpy(pair.x))

    jm = pair.jmodel
    tx = configure_optimizers(1e-4, 1e-3, 1.0)

    def loss_fn(p, xx):
        out = jm.apply({"params": p}, xx, training=True,
                       rngs={"noise": jax.random.key(0)})
        rd = jax_rd_loss(out, xx, LMBDA)
        aux = jm.apply({"params": p}, method="aux_loss")
        return rd.loss + SPARSE * jgd.gate_l1_penalty(p) + aux, (rd, aux)

    @jax.jit
    def run(p, xx):
        (_, (rd, aux)), g = jax.value_and_grad(loss_fn, has_aux=True)(p, xx)
        updates, _ = tx.update(g, tx.init(p), p)
        return rd, aux, g, optax.apply_updates(p, updates)

    with pytest.MonkeyPatch.context() as mp:
        queues = replay_draws(mp, rec.uniform_draws, rec.bernoulli_draws)
        rd, aux, jgrads, stepped = run(pair.params, pair.x)
    assert not any(queues)
    return SimpleNamespace(
        metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
        masks=masks, port=port, jgrads=_np(jgrads), stepped=_np(stepped),
        jmetrics={"loss": float(rd.loss), "bpp_loss": float(rd.bpp_loss),
                  "aux": float(aux)})


def test_tock_step_matches_jax(pair, tock):
    """The RD loss, bpp and aux within rel 1e-5; every gradient, the
    gates' (RD plus the L1 term) included, within 2e-4 of its tensor's
    largest JAX gradient; the masks untouched by the port's dual Adam and
    by JAX's (which labels them frozen)."""
    for k in ("loss", "bpp_loss", "aux"):
        np.testing.assert_allclose(tock.metrics[k], tock.jmetrics[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    bad = _bad_gradients(tock.grads, tock.jgrads)
    assert not bad, bad
    gates = [k for k in tock.grads if k.endswith(".gate")]
    assert len(gates) == 3 * 3 + 3 * 4 * 2
    assert all(tock.grads[k].abs().max() > 0 for k in gates)
    for path, g in iter_gates(tock.port):
        assert torch.equal(g.mask, tock.masks[path]), path
    before = state_dict_from_jax(pair.params, "cc_gd")
    after = state_dict_from_jax(tock.stepped, "cc_gd")
    for k in before:
        if k.endswith(".mask"):
            assert torch.equal(before[k], after[k]), k
    assert not torch.equal(before["h_a.1.gate"], after["h_a.1.gate"])


# -- the tick ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tick_pair(pair):
    """The tick's gate gradients and Taylor scores, port and JAX, from one
    batch at the same noise."""
    port = copy.deepcopy(pair.port)
    rec = RecordingSampler(Sampler(torch.Generator().manual_seed(SEED)))
    grads = train_gd.tick_grads(port, torch.from_numpy(pair.x), LMBDA, rec)
    scores = accumulate_scores({}, port, grads)
    jm = pair.jmodel

    def loss_fn(p, xx):
        out = jm.apply({"params": p}, xx, training=True,
                       rngs={"noise": jax.random.key(0)})
        return jax_rd_loss(out, xx, LMBDA).loss

    with pytest.MonkeyPatch.context() as mp:
        queues = replay_draws(mp, rec.uniform_draws, rec.bernoulli_draws)
        jgrads = jax.jit(jax.grad(loss_fn))(pair.params, pair.x)
    assert not any(queues)
    jgrads = _np(jgrads)
    jscores = jgd.accumulate_scores({}, _np(pair.params), jgrads)
    return SimpleNamespace(port=port, grads=grads, scores=scores,
                           jgrads=jgrads, jscores=_flat(jscores))


def test_tick_scores_match_jax(tick_pair):
    """The port's tick reads only the gates' gradient (autograd.grad); the
    Taylor scores |dL/dgate * gate| within 2e-4 of each gate's largest JAX
    score, for all 33 gates; a second accumulation doubles them."""
    got, want = tick_pair.scores, tick_pair.jscores
    assert set(got) == set(want) and len(got) == 33
    for k, w in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == w.shape
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(), err_msg=k)
        assert np.abs(w).max() > 0, k
    twice = accumulate_scores(got, tick_pair.port, tick_pair.grads)
    for k in got:
        np.testing.assert_array_equal(twice[k], 2 * got[k])
    assert all(p.grad is None for p in tick_pair.port.parameters())


def _shared_scores(port, seed):
    """Scores for every gate, shared by both packages: random, with ties
    at the 1/64 grid, one gate all tied, one gate far below the rest (its
    floor keeps max(int(0.04 C), 1) of it)."""
    r = np.random.default_rng(seed)
    out = {}
    for i, (path, g) in enumerate(iter_gates(port)):
        C = g.mask.numel()
        s = np.round(r.uniform(0, 1, C) * 64) / 64
        if i == 3:
            s[:] = 0.25
        if i == 5:
            s = s * 1e-3
        out[path] = s.astype(np.float32)
    return out


@pytest.mark.parametrize("num", [1, 40, 400])
def test_prune_masks_on_shared_scores_equal_jax(pair, num):
    """The same scores through both prune_masks give exactly JAX's masks:
    the global threshold over the alive channels, ties at it pruned
    together, each gate's floor; already-masked channels stay masked."""
    port = copy.deepcopy(pair.port)
    scores = _shared_scores(port, num)
    before = {p: g.mask.reshape(-1).clone() for p, g in iter_gates(port)}
    params = jax.tree_util.tree_map(np.asarray, pair.params)
    jscores = {tuple(k.split("/")): v for k, v in scores.items()}
    want = {"/".join(p): np.asarray(m) for p, _, m in
            jgd.iter_gate_paths(jgd.prune_masks(params, jscores, num=num))}
    prune_masks(port, scores, num=num)
    pruned = 0
    for path, g in iter_gates(port):
        got = g.mask.reshape(-1).numpy()
        np.testing.assert_array_equal(got, want[path], err_msg=path)
        assert not (got > before[path].numpy()).any()
        pruned += int((before[path].numpy() > got).sum())
    assert pruned >= num


def test_tick_optimizer_moves_only_the_gates_as_optax(pair, tick_pair):
    """The tick's Adam over the gates, given JAX's tick gradients then
    half of them: every other parameter and buffer bit-unchanged, the
    gates within two f32 ulps plus 2e-5 of the learning rate of optax's
    multi_transform update (`make_gate_tx`)."""
    lr = 1e-4
    port = copy.deepcopy(pair.port)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    want_grads = state_dict_from_jax(tick_pair.jgrads, "cc_gd")
    opt = make_gate_optimizer(port, lr)
    for scale in (1.0, 0.5):
        for n, p in port.named_parameters():
            p.grad = want_grads[n] * scale if n.endswith(".gate") else \
                torch.ones_like(p)  # a gradient the optimizer must ignore
        opt.step()
    tx = jgd.make_gate_tx(lr)
    params = pair.params
    opt_state = tx.init(params)
    for scale in (1.0, 0.5):
        g = jax.tree_util.tree_map(lambda t: t * scale, tick_pair.jgrads)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    want = state_dict_from_jax(_np(params), "cc_gd")
    got = port.state_dict()
    moved = 0
    for k, v in got.items():
        if k.endswith(".gate"):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=PARAM_RTOL, atol=2e-5 * lr,
                                       err_msg=k)
            moved += not torch.equal(v, before[k])
        else:
            assert torch.equal(v, before[k]), k
    assert moved == 33


def test_param_scale_equals_jax(pair):
    got = param_scale(pair.port)
    assert got == jgd.param_scale(pair.params)
    assert 0.5 < got < 0.8  # a third of the channels masked
    assert param_scale(CC_GD(**SMALL)) == 1.0


def test_tick_prunes_and_keeps_floors(pair):
    """`tick`: two rounds over two batches prune 2 x num channels or more
    (ties), never unmask one, keep every gate's floor; only gates moved."""
    port = copy.deepcopy(pair.port)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    x = torch.from_numpy(pair.x)
    sampler = Sampler(torch.Generator().manual_seed(3))
    scale = param_scale(port)
    train_gd.tick(port, lambda: iter([x[:1], x[1:]]), LMBDA, sampler,
                  rounds=2, num=10, learning_rate=1e-3)
    kept = {p: int(g.mask.sum()) for p, g in iter_gates(port)}
    total = sum(g.mask.numel() for _, g in iter_gates(port))
    assert param_scale(port) <= scale - 20 / total
    for path, g in iter_gates(port):
        assert kept[path] >= max(int(0.04 * g.mask.numel()), 1), path
    for k, v in port.state_dict().items():
        if k.endswith(".mask"):
            assert not (v > before[k]).any(), k
        elif not k.endswith(".gate"):
            assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in port.parameters())


# -- the pruned export -------------------------------------------------------------

def _jax_load_pruned(path):
    """JAX's `load_pruned_checkpoint` with the flax template shaped by
    `jax.eval_shape` (`_torch_port.jax_template`) in place of flax's init,
    which costs over a minute of CPU here: the same model, the same
    msgpack read into it."""
    from flax import serialization

    from stf_tpu.models.cc_gd import CC_GD as JaxCC_GD
    from _torch_port import jax_template

    with open(path + ".deps.json") as f:
        meta = json.load(f)
    model = JaxCC_GD(deps=tuple(sorted(meta["deps"].items())),
                     **meta["model_kwargs"])
    with open(path, "rb") as f:
        return model, serialization.from_bytes(jax_template(model), f.read())


@pytest.fixture(scope="module")
def exports(pair, tmp_path_factory):
    """Both packages' prune_export of the same masked weights (z's gate
    masked too), and each package's reload."""
    root = tmp_path_factory.mktemp("pruned")
    sd, deps = prune_export(pair.port, str(root / "port"))
    jparams, jdeps = jgd.prune_export(
        pair.params, str(root / "jax"), model_kwargs=dict(SMALL))
    jmodel, jloaded = _jax_load_pruned(
        str(root / "jax" / "pruned_model.msgpack"))
    path = str(root / "port" / "pruned_model.pth.tar")
    return SimpleNamespace(sd=sd, deps=deps, jparams=_np(jparams),
                           jdeps=jdeps, jmodel=jmodel, jloaded=jloaded,
                           path=path, port=load_pruned_checkpoint(path,
                                                                  "cpu"))


def test_prune_export_equals_jax(pair, exports):
    """The exported tensors equal JAX's export carried to torch names, the
    deps equal JAX's, and the sidecar has JAX's keys; the weights are the
    ungated CC_GD(deps=...) layout at the kept widths."""
    want = state_dict_from_jax(exports.jparams, "cc_gd")
    assert exports.sd.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(exports.sd[k], v), k
    assert exports.deps == exports.jdeps
    assert all(k.endswith("/gate_" + k[-1]) for k in exports.deps)
    assert exports.deps["h_a/gate_2"] < SMALL["N"]
    assert exports.deps["h_mean_s/gate_2"] < SMALL["M"]
    with open(exports.path + ".deps.json") as f:
        meta = json.load(f)
    assert meta == {"deps": exports.deps, "model_kwargs": SMALL}
    assert not any(isinstance(m, GateDecorator)
                   for m in exports.port.modules())
    assert not any(k.endswith((".gate", ".mask")) for k in exports.sd)


def test_pruned_reload_forward_matches_jax(exports):
    x = fam.images(64)
    got = fam.port_forward(exports.port, x)
    want = fam.jax_forward(exports.jmodel, exports.jloaded, x)
    fam.check_forward(got, want, 64, y_ch=40, z_ch=exports.deps["h_a/gate_2"])


def test_pruned_lane_stream_matches_jax(exports):
    """The reloaded pruned model's per-slice lane stream, symbols, indexes
    and z strings equal JAX's pruned codec's."""
    c = fam.codecs(exports.jmodel, exports.jloaded, exports.port)
    fam.check_streams_match_jax(c, 4)


def test_pruned_model_is_the_gated_model_with_z_unmasked(pair, tmp_path):
    """With h_a/gate_2 unmasked (pruning z is approximate by design: the
    eval forward rounds z around each channel's median), the pruned
    model's eval forward is the masked gated model's within 1e-5."""
    gated = copy.deepcopy(pair.port)
    with torch.no_grad():
        dict(iter_gates(gated))["h_a/gate_2"].mask.fill_(1.0)
    _, deps = prune_export(gated, str(tmp_path))
    pruned = load_pruned_checkpoint(str(tmp_path / "pruned_model.pth.tar"),
                                    "cpu")
    assert deps["h_a/gate_2"] == SMALL["N"] and deps["h_a/gate_0"] < SMALL["M"]
    x = fam.images(64)
    got, want = fam.port_forward(pruned, x), fam.port_forward(gated, x)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)


# -- the CLI -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    return fam.png_folder(tmp_path_factory.mktemp("gdds"))


def test_train_gd_cli_ticks_exports_and_evaluates(tiny_dataset, tmp_path,
                                                  monkeypatch, capsys):
    """`train_gd.main --device cpu --tick-freq 1`: two tock steps an
    epoch, a tick after each epoch (the scale falls), checkpoints, the
    pruned export; then the eval CLI (`-a cc_gd`) on the export and a
    resume at the next epoch."""
    from stf_tpu_torch.cli import eval_model
    from stf_tpu_torch.training.checkpoint import load_checkpoint
    from stf_tpu_torch.zoo import models

    monkeypatch.setitem(models, "cc_gd_tiny_test", lambda: CC_GD(**SMALL))
    save_dir = str(tmp_path / "ckpt")
    argv = ["-m", "cc_gd_tiny_test", "-d", tiny_dataset, "-e", "2",
            "--batch-size", "2", "--patch-size", "64", "64",
            "--tick-freq", "1", "--tick-round", "2", "--tick-num", "30",
            "--subset-scale", "0.5", "--flops-target", "0.1",
            "--save-dir", save_dir, "--num-workers", "2", "--device", "cpu"]
    state = train_gd.main(argv)
    assert state.step == 4
    out = capsys.readouterr().out
    assert out.count("tick at epoch") == 2
    scales = [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
              if line.startswith("post-tick param scale")]
    assert len(scales) == 2 and scales[1] < scales[0] < 1.0
    assert "gd test epoch 1: loss" in out
    ckpt = load_checkpoint(os.path.join(save_dir, "checkpoint.pth.tar"))
    assert ckpt["epoch"] == 1 and ckpt["model"] == "cc_gd_tiny_test"
    path = os.path.join(save_dir, "pruned_model.pth.tar")
    pruned = load_pruned_checkpoint(path, "cpu")
    gated = {p: int(g.mask.sum()) for p, g in iter_gates(state.model)}
    with open(path + ".deps.json") as f:
        assert json.load(f)["deps"] == gated

    eval_model.main(["-d", os.path.join(tiny_dataset, "test"), "-a", "cc_gd",
                     "-p", path, "-r", str(tmp_path / "recon"),
                     "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["name"] == "cc_gd" and doc["results"]["bpp"][0] > 0
    assert len(os.listdir(tmp_path / "recon")) == 2
    assert pruned.M == SMALL["M"]

    i = argv.index("-e")
    state2 = train_gd.main(argv[:i] + ["-e", "3"] + argv[i + 2:] + [
        "--checkpoint", os.path.join(save_dir, "checkpoint.pth.tar")])
    assert state2.step == 6
    assert "at epoch 2" in capsys.readouterr().out


def test_train_gd_cli_pretrained_restores_the_state_at_epoch_0(
        pair, tiny_dataset, tmp_path, monkeypatch, capsys):
    """`--pretrained` with a CC_GD trainer checkpoint (as the JAX CLI): the
    model, both optimizers, the masks and the step are restored, the epoch
    counter is not (training starts at epoch 0), and the export written
    from the restored masks reads back."""
    from stf_tpu_torch.training.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from stf_tpu_torch.zoo import models

    # a trainer checkpoint at epoch 5, one step in: Adam moments nonzero,
    # a third of the channels masked
    state = TrainState(copy.deepcopy(pair.port), "cpu", seed=SEED)
    make_gd_train_step(state.model, LMBDA, SPARSE)(
        state, torch.from_numpy(fam.images(64, seed=3)))
    pre = save_checkpoint(str(tmp_path / "pre"), state, 5, 1.0,
                          {"model": "cc_gd", "lmbda": LMBDA, "metric": "mse"},
                          False, 1.0)
    want = load_checkpoint(pre)

    monkeypatch.setitem(models, "cc_gd_tiny_test", lambda: CC_GD(**SMALL))
    save_dir = str(tmp_path / "ckpt")
    argv = ["-m", "cc_gd_tiny_test", "-d", tiny_dataset, "--batch-size", "2",
            "--patch-size", "64", "64", "--tick-freq", "10",
            "--save-dir", save_dir, "--num-workers", "2", "--device", "cpu",
            "--pretrained", pre]
    restored = train_gd.main(argv + ["-e", "0"]).state_dict()
    for k, v in want["state_dict"].items():
        assert torch.equal(restored["state_dict"][k], v), k
    for opt in ("optimizer", "aux_optimizer"):
        for i, s in want[opt]["state"].items():
            for k, v in s.items():
                assert torch.equal(restored[opt]["state"][i][k], v), (opt, k)
    assert restored["step"] == want["step"] == 1
    path = os.path.join(save_dir, "pruned_model.pth.tar")
    with open(path + ".deps.json") as f:
        assert json.load(f)["deps"] == {
            p: int(g.mask.sum()) for p, g in iter_gates(state.model)}
    assert load_pruned_checkpoint(path, "cpu").M == SMALL["M"]

    capsys.readouterr()
    state2 = train_gd.main(argv + ["-e", "1"])
    out = capsys.readouterr().out
    assert f"started from {pre}" in out and "gd epoch 0 [0]" in out
    assert state2.step == 3
    assert load_checkpoint(os.path.join(save_dir, "checkpoint.pth.tar"))[
        "epoch"] == 0


def test_train_gd_cli_defaults_to_cuda_and_raises_without_a_card(
        tiny_dataset):
    assert train_gd.parse_args(["-d", tiny_dataset]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gd.main(["-d", tiny_dataset, "-e", "1"])
