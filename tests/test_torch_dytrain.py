"""DYSTF distillation (`stf_tpu_torch.training.dytrain`) against the JAX
package on the CPU, at the same weights, batch and random draws.

The student is a small DYSTF whose schedule trains (`DYSTF_TRAIN`: its
last pruned stage scores twice, so the second predictor scores the merge
of the two token tensors; `DYSTF_SMALL`'s schedule scores before its first
routed block, which the training routing of neither package can run); the
teacher a small STF built with `is_teacher` (`STF_SMALL`, the same y
width). Weights are drawn by `init_weights` and scaled by `he_scale`; the
JAX pair holds the same weights (`_torch_port.to_jax`). The port's draws
(quantization noise, DropPath masks, Gumbel noise) are recorded and
replayed into the JAX step (`_torch_replay`), the JAX step's loss being
`stf_tpu/training/dytrain.py:80-94`'s `loss_fn`.

Tolerances: forward outputs within `FORWARD_TOL` (1e-4, as the eval
forward's), the decision masks exactly (one-hot forwards of the same
argmax); loss parts rel 1e-5; each student gradient within 2e-4 of that
tensor's largest JAX gradient (as the RD step's, `test_torch_train.py`).
"""

import copy
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_family as fam
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import DYSTF_TRAIN, STF_SMALL, to_jax
from _torch_replay import RecordingSampler, replay_draws
from _torch_scale import he_scale
from stf_tpu.models.dystf import DYSTF as JaxDYSTF
from stf_tpu.models.dystf import gumbel_softmax_hard as jax_gumbel_hard
from stf_tpu.models.stf import SymmetricalTransFormer as JaxSTF
from stf_tpu.training.dytrain import distill_pruning_loss as jax_distill
from stf_tpu_torch.models import DYSTF, SymmetricalTransFormer, dystf
from stf_tpu_torch.models import init_weights
from stf_tpu_torch.training import (
    Sampler,
    TrainState,
    distill_pruning_loss,
    make_dytrain_step,
)
from stf_tpu_torch.zoo import (
    create_model,
    load_checkpoint,
    save_checkpoint,
    state_dict_from_jax,
)

LMBDA = 0.013
KEEP = (0.75, 0.5, 0.25)
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4  # of each tensor's largest JAX gradient
SEED = 11  # the step's sampler
# gradients that are zero in exact arithmetic at clf_weight 0 (see
# test_dytrain_step_matches_jax)
SYMMETRIC_ZERO = ("end_conv.2.bias",)
PARTS = ("loss", "rd_loss", "bpp_loss", "pred_loss", "cls_kl", "token_kl",
         "aux_loss")


def _small(cls, config, name, seed):
    gen = torch.Generator().manual_seed(seed)
    return he_scale(init_weights(cls(**config), gen), gen, name).eval()


@pytest.fixture(scope="module")
def pair():
    """The student and the teacher, each with its JAX twin, and a batch."""
    student = _small(DYSTF, DYSTF_TRAIN, "dystf", 6)
    teacher = _small(SymmetricalTransFormer, STF_SMALL, "stf", 4)
    teacher.is_teacher = True
    jstudent, sparams = to_jax("dystf", student,
                               model=JaxDYSTF(**DYSTF_TRAIN))
    jteacher, tparams = to_jax("stf", teacher,
                               model=JaxSTF(**STF_SMALL, is_teacher=True))
    return SimpleNamespace(student=student, teacher=teacher,
                           jstudent=jstudent, sparams=sparams,
                           jteacher=jteacher, tparams=tparams,
                           x=fam.images(64))


def _rngs():
    r = jax.random.split(jax.random.key(0), 3)
    return {"noise": r[0], "gumbel": r[1], "droppath": r[2]}


def _np_out(out):
    """A training forward's outputs as NumPy: x_hat, the likelihoods, y
    and the decision masks."""
    return {"x_hat": np.asarray(out["x_hat"]),
            **{k: np.asarray(v) for k, v in out["likelihoods"].items()},
            "latent": np.asarray(out["y"]),
            "decisions": [np.asarray(d) for d in out["decisions"]]}


@pytest.fixture(scope="module")
def port_forward(pair):
    """The port's training forward with the step's sampler seed (so the
    step draws the same values), its draws recorded."""
    rec = RecordingSampler(Sampler(torch.Generator().manual_seed(SEED)))
    pair.student.train()
    try:
        with torch.no_grad():
            out = pair.student(torch.from_numpy(pair.x), training=True,
                               sampler=rec)
    finally:
        pair.student.eval()
    return SimpleNamespace(out=out, np=_np_out(out), draws=rec)


@pytest.fixture(scope="module")
def jax_step(pair, port_forward):
    """The JAX step's loss_fn (`stf_tpu/training/dytrain.py:80-94`) under
    value_and_grad, fed the port's draws, jitted once with clf_weight an
    argument: clf -> (parts, gradients, the student's outputs)."""
    js, jt, tparams = pair.jstudent, pair.jteacher, pair.tparams

    def loss_fn(p, xx, clf):
        s_out = js.apply({"params": p}, xx, training=True, rngs=_rngs())
        t_out = jax.lax.stop_gradient(
            jt.apply({"params": tparams}, xx, training=False))
        loss, parts = jax_distill(s_out, t_out, xx, LMBDA, KEEP, 10.0, 0.5,
                                  clf)
        aux = js.apply({"params": p}, method="aux_loss")
        parts["aux_loss"] = aux
        return loss + aux, (parts, s_out, t_out)

    run = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    d = port_forward.draws
    with pytest.MonkeyPatch.context() as mp:
        queues = replay_draws(mp, d.uniform_draws, d.bernoulli_draws,
                              d.gumbel_draws)
        run(pair.sparams, pair.x, 0.0)  # traced here, with the draws
    assert not any(queues), "the JAX step drew fewer values than the port"
    cache = {}

    def at(clf):
        if clf not in cache:
            (_, (parts, s_out, t_out)), grads = run(pair.sparams, pair.x,
                                                    clf)
            cache[clf] = SimpleNamespace(
                parts={k: float(v) for k, v in parts.items()},
                grads=jax.tree_util.tree_map(np.asarray, grads),
                out=_np_out(s_out), teacher=t_out)
        return cache[clf]

    return at


# -- the Gumbel-softmax and the sampler ---------------------------------------

class _ZeroNoise:
    def gumbel(self, shape, like):
        return torch.zeros(shape, dtype=like.dtype)


def test_gumbel_softmax_hard_matches_jax(monkeypatch):
    """At the same logits and noise the forward is JAX's exact one-hot and
    the gradient JAX's; with every logit tied and no noise both pick the
    first index."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 16, 2)).astype(np.float32)
    w = rng.normal(size=logits.shape).astype(np.float32)
    rec = RecordingSampler(Sampler(torch.Generator().manual_seed(3)))
    t = torch.tensor(logits, requires_grad=True)
    y = dystf.gumbel_softmax_hard(t, rec)
    (y * torch.from_numpy(w)).sum().backward()
    # the forward and the gradient each draw once on the JAX side
    replay_draws(monkeypatch, [], [], rec.gumbel_draws * 2)
    key = jax.random.key(0)
    want = jax_gumbel_hard(key, jnp.asarray(logits))
    gwant = jax.grad(lambda v: jnp.sum(jax_gumbel_hard(key, v) * w))(
        jnp.asarray(logits))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    assert set(np.unique(y.detach().numpy())) == {0.0, 1.0}
    np.testing.assert_array_equal(y.detach().numpy().sum(-1), 1.0)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(gwant), rtol=1e-5,
                               atol=1e-7)
    assert np.abs(t.grad.numpy()).max() > 0.01

    tied = torch.zeros(2, 5, 3)
    got = dystf.gumbel_softmax_hard(tied, _ZeroNoise())
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape, dtype, mode=None: jnp.zeros(shape))
    want = jax_gumbel_hard(key, jnp.zeros((2, 5, 3)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[..., 0], 1.0)


def test_sampler_gumbel_is_finite_at_a_zero_uniform(monkeypatch):
    """A u of 0 from torch.rand is raised to finfo.tiny, as JAX's gumbel
    draws u in [tiny, 1): the noise stays finite."""
    monkeypatch.setattr(torch, "rand", lambda shape, **k: torch.zeros(shape))
    g = Sampler(torch.Generator()).gumbel((3,), torch.zeros(1))
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_allclose(g.numpy(), -np.log(-np.log(tiny)), rtol=1e-6)


# -- STF's teacher output -------------------------------------------------------

def test_stf_teacher_returns_y_matching_jax(pair, tmp_path):
    """An STF saved by the zoo and loaded with is_teacher returns the NHWC
    latent y, within FORWARD_TOL of the JAX teacher's; without the flag
    the forward has no y."""
    path = str(tmp_path / "teacher.pth.tar")
    save_checkpoint(path, "stf", pair.teacher, STF_SMALL)
    loaded = load_checkpoint(path, "stf", device="cpu", is_teacher=True)
    assert loaded.is_teacher
    with torch.no_grad():
        got = loaded(torch.from_numpy(pair.x))
    want = jax.jit(lambda p, v: pair.jteacher.apply(
        {"params": p}, v, training=False))(pair.tparams, pair.x)
    assert got["y"].shape == (2, 4, 4, 128)
    for k in ("x_hat", "y"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=fam.FORWARD_TOL, err_msg=k)
    assert np.abs(got["y"].numpy()).max() > 1.0
    plain = create_model("stf", **STF_SMALL).eval()
    assert not plain.is_teacher and create_model("stf", is_teacher=True,
                                                 **STF_SMALL).is_teacher
    with torch.no_grad():
        assert "y" not in plain(torch.from_numpy(pair.x))


# -- the training forward -------------------------------------------------------

def test_training_forward_matches_jax(port_forward, jax_step):
    """x_hat, the likelihoods and y within FORWARD_TOL of the JAX training
    forward at the same draws; the last pruned stage's two keep masks
    exactly JAX's."""
    got, want = port_forward.np, jax_step(0.0).out
    assert got["latent"].shape == (2, 4, 4, 128)
    for k in ("x_hat", "y", "z", "latent"):
        np.testing.assert_allclose(got[k], want[k], atol=fam.FORWARD_TOL,
                                   err_msg=k)
    assert [d.shape for d in got["decisions"]] == [(2, 16, 1)] * 2
    assert len(want["decisions"]) == 2
    for g, w in zip(got["decisions"], want["decisions"]):
        np.testing.assert_array_equal(g, w)
    # the masks are live: some tokens kept, some dropped
    assert 0 < got["decisions"][0].mean() < 1
    assert port_forward.draws.gumbel_draws and any(
        not m.all() for _, m in port_forward.draws.bernoulli_draws)


def test_distill_loss_matches_jax(pair, port_forward, jax_step):
    """Each part of the loss on the same student and teacher outputs (the
    port's student's, JAX's teacher's, as NumPy to both) within rel 1e-5
    of JAX's."""
    out = port_forward.out
    t_out = jax_step(0.0).teacher
    teacher = {k: torch.from_numpy(np.array(t_out[k])) for k in ("x_hat", "y")}
    x = torch.from_numpy(pair.x)
    _, got = distill_pruning_loss(out, teacher, x, LMBDA, KEEP,
                                  clf_weight=1.0)
    jout = {"x_hat": jnp.asarray(out["x_hat"].numpy()),
            "likelihoods": {k: jnp.asarray(v.numpy())
                            for k, v in out["likelihoods"].items()},
            "decisions": [jnp.asarray(d.numpy()) for d in out["decisions"]],
            "y": jnp.asarray(out["y"].numpy())}
    _, want = jax_distill(jout, t_out, jnp.asarray(x.numpy()), LMBDA, KEEP,
                          clf_weight=1.0)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert float(want["pred_loss"]) > 0 and float(want["cls_kl"]) > 0


# -- one step ---------------------------------------------------------------------

def _port_step(pair, clf):
    """One make_dytrain_step on copies of the student and the teacher
    (sampler seed SEED): (parts, {name: grad, zero where none}, teacher
    state before, teacher after)."""
    student = copy.deepcopy(pair.student)
    teacher = copy.deepcopy(pair.teacher)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    state = TrainState(student, "cpu", seed=SEED)
    grads = {}
    update = state.apply_gradients

    def apply_gradients():
        grads.update({n: torch.zeros_like(p) if p.grad is None
                      else p.grad.clone()
                      for n, p in student.named_parameters()})
        update()

    state.apply_gradients = apply_gradients
    step = make_dytrain_step(student, teacher, LMBDA, KEEP, clf_weight=clf)
    parts = step(state, torch.from_numpy(pair.x))
    assert all(p.grad is None for p in teacher.parameters())
    return ({k: float(v) for k, v in parts.items()}, grads, before,
            teacher.state_dict())


def _bad_gradients(port_grads, jax_grads):
    want = state_dict_from_jax(jax_grads, "dystf")
    assert set(want) == set(port_grads), set(want) ^ set(port_grads)
    return {k: ((port_grads[k] - w).abs().max().item(), w.abs().max().item())
            for k, w in want.items()
            if not (port_grads[k] - w).abs().max().item()
            <= GRAD_TOL * w.abs().max().item()}


@pytest.fixture(scope="module", params=[0.0, 1.0], ids=["clf0", "clf1"])
def step_pair(request, pair):
    clf = request.param
    return (clf, *_port_step(pair, clf))


def test_dytrain_step_matches_jax(step_pair, jax_step):
    """Loss parts within rel 1e-5, every student gradient within 2e-4 of
    its tensor's largest JAX gradient, the predictors' gradients nonzero,
    the teacher bit-unchanged. At clf_weight 0 the slice transforms' scale
    stacks get no gradient in either package."""
    clf, parts, grads, before, after = step_pair
    want = jax_step(clf)
    assert set(parts) == set(PARTS)
    for k in PARTS:
        np.testing.assert_allclose(parts[k], want.parts[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    bad = _bad_gradients(grads, want.grads)
    if clf == 0:
        # without the RD term the last conv's bias reaches the loss only
        # through the softmaxes over W, which a per-channel constant does
        # not change: its gradient is zero in exact arithmetic, and both
        # packages give rounding noise (JAX 1.8e-7, the port 6.9e-7)
        jgrads = state_dict_from_jax(want.grads, "dystf")
        for k in SYMMETRIC_ZERO:
            assert grads[k].abs().max() < 1e-5, k
            assert jgrads[k].abs().max() < 1e-5, k
            bad.pop(k, None)
    assert not bad, bad
    for k, g in grads.items():
        if ".score_predictor." in k:
            assert g.abs().max() > 0, k
    scale = [g.abs().max().item() for k, g in grads.items()
             if k.startswith("cc_scale_transforms.")]
    assert (max(scale) > 0) == (clf > 0)
    assert before.keys() == after.keys()
    for k, v in before.items():
        assert torch.equal(v, after[k]), k


def _no_straight_through(logits, sampler, dim=-1):
    y = torch.softmax(logits + sampler.gumbel(logits.shape, logits), dim)
    return torch.zeros_like(y).scatter_(dim, y.argmax(dim, keepdim=True), 1.0)


@pytest.mark.parametrize("fault", ["no_straight_through", "x1_x2_swapped"])
def test_step_comparison_catches_planted_faults(pair, jax_step, monkeypatch,
                                                fault):
    """The Gumbel mask without its straight-through term (the predictors
    get no gradient from the routing), or the routed block given [x2, x1]:
    the step must miss JAX's loss parts or gradients."""
    if fault == "no_straight_through":
        monkeypatch.setattr(dystf, "gumbel_softmax_hard",
                            _no_straight_through)
    else:
        forward = dystf.AdaSwinTransformerBlock.forward_masked
        monkeypatch.setattr(
            dystf.AdaSwinTransformerBlock, "forward_masked",
            lambda self, state, *a: forward(self, state[::-1], *a))
    parts, grads, _, _ = _port_step(pair, 1.0)
    want = jax_step(1.0)
    off = [k for k in PARTS
           if not np.isclose(parts[k], want.parts[k], rtol=LOSS_RTOL, atol=0)]
    bad = _bad_gradients(grads, want.grads)
    assert off or bad
    if fault == "no_straight_through":
        assert any(".score_predictor." in k for k in bad)


# -- the CLI -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    return fam.png_folder(tmp_path_factory.mktemp("dyds"))


def test_dytrain_cli_with_a_teacher_checkpoint_and_resume(
        pair, tiny_dataset, tmp_path, monkeypatch, capsys):
    """`dytrain.main --device cpu`: the teacher read from a port checkpoint
    (is_teacher), two steps an epoch, a test epoch, checkpoints; a resume
    with a higher -e starts at the next epoch with the saved step. The
    student and teacher are the small models under test-only registry
    names (the teacher's is the student's without `dy`)."""
    from stf_tpu_torch import zoo
    from stf_tpu_torch.training import dytrain
    from stf_tpu_torch.training.checkpoint import load_checkpoint as load_ckpt

    monkeypatch.setitem(zoo.models, "dystf_tiny_test",
                        lambda **kw: DYSTF(**DYSTF_TRAIN, **kw))
    monkeypatch.setitem(zoo.models, "stf_tiny_test",
                        lambda **kw: SymmetricalTransFormer(**STF_SMALL, **kw))
    teacher_path = str(tmp_path / "teacher.pth.tar")
    save_checkpoint(teacher_path, "stf_tiny_test", pair.teacher)
    loaded = []
    real_load = zoo.load_checkpoint
    monkeypatch.setattr(zoo, "load_checkpoint", lambda *a, **k: loaded.append(
        real_load(*a, **k)) or loaded[-1])
    save_dir = str(tmp_path / "ckpt")
    argv = ["-m", "dystf_tiny_test", "-d", tiny_dataset, "-e", "1",
            "--batch-size", "2", "--patch-size", "64", "64",
            "--ratio", "0.75,0.5,0.25", "--clf-weight", "1",
            "--teacher-checkpoint", teacher_path, "--save-dir", save_dir,
            "--num-workers", "2", "--log-every", "1", "--device", "cpu"]
    state = dytrain.main(argv)
    assert state.step == 2
    out = capsys.readouterr().out
    assert out.count("dytrain epoch 0") == 2
    assert "dytrain test epoch 0: loss" in out
    assert len(loaded) == 1 and loaded[0].is_teacher
    for k, v in pair.teacher.state_dict().items():
        assert torch.equal(loaded[0].state_dict()[k], v), k
    path = os.path.join(save_dir, "checkpoint.pth.tar")
    ckpt = load_ckpt(path)
    assert (ckpt["epoch"], ckpt["step"], ckpt["model"]) == (
        0, 2, "dystf_tiny_test")
    assert np.isfinite(ckpt["loss"])

    i = argv.index("-e")
    state2 = dytrain.main(argv[:i] + ["-e", "2"] + argv[i + 2:]
                          + ["--checkpoint", path])
    assert state2.step == 4
    out = capsys.readouterr().out
    assert f"resumed from {path} at epoch 1" in out
    assert "dytrain epoch 1 [0]" in out and "dytrain epoch 0" not in out
    assert load_ckpt(path)["epoch"] == 1


def test_dytrain_cli_defaults_to_cuda_and_raises_without_a_card(tiny_dataset):
    from stf_tpu_torch.training import dytrain

    assert dytrain.parse_args(["-d", tiny_dataset]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dytrain.main(["-d", tiny_dataset, "-e", "1"])
