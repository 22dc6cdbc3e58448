"""Multi-process training of the port (`stf_tpu_torch.parallel`, the
sharded checkpoint, the trainer CLIs' ranks) on the CPU over gloo, against
the single-process port step and the JAX package's data-parallel step.

One module-scoped group of two ranks (`_torch_ranks.RankGroup`, no JAX in
the ranks) does all of this file's collective work; every call has a
timeout, after which the ranks are killed and the test fails. The ranks
build the same small models as `_torch_port.port_small` (init_weights at
a seed, He scale; the cnn at `TINY`, `tests/test_parallel.py`'s config)
and take their rows of a global batch of 2 at 64x64.

Tolerances: metrics rel 1e-5, and parameters after one or two updates
within atol 5e-4, JAX's own for its data-parallel step
(`tests/test_parallel.py:53-56`). Both bounds are loose on what the
parallel step adds: the metrics of the first step come before any
update, and Adam's first step moves a parameter by about lr x sign(g)
(lr 1e-4) whatever the gradient's size. So each step is also held to
Adam's first moment after the first update, (1 - beta1) x the gradient
averaged over the ranks and clipped to the global norm 1 (the clip is
active at these weights, checked): within MOMENT_RTOL (1e-3) of each
tensor's largest entry. Rounding the batch's sums in two halves moves it
by up to about 7e-5 of that (1e-7 between DDP and --tp 2); a lost or
doubled all-reduce, or a norm that missed a shard, moves it by tens of
percent.
"""

import os

import jax
import numpy as np
import pytest
import torch

import _torch_family as fam
import _torch_ranks as tr
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import to_jax
from _torch_replay import RecordingSampler, replay_draws
from stf_tpu_torch.training import (
    Sampler,
    TrainState,
    make_dytrain_step,
    make_train_step,
)
from stf_tpu_torch.training.state import is_aux_parameter

LMBDA = 0.013
KEEP = (0.75, 0.5, 0.25)
METRIC_RTOL = 1e-5
PARAM_ATOL = 5e-4
MOMENT_RTOL = 1e-3
BETA1 = 0.9  # torch's and optax's Adam
SEED = 11  # the trainer's sampler, in the ranks and here
TINY = dict(N=16, M=24, num_slices=2, max_support_slices=1)
# each model's config over its small one, and the steps it takes: the
# second update of the cnn runs on the Adam moments of the first (sharded
# with --tp 2), and DDP checks there that every parameter took a gradient
# in the first; the stf adds its attention, norms and DropPath masks to
# one step
CONFIG = {"cnn": TINY, "stf": {}}
STEPS = {"cnn": 2, "stf": 1}


@pytest.fixture(scope="module")
def ranks():
    group = tr.RankGroup(2)
    yield group
    group.close()


@pytest.fixture(scope="module")
def x():
    return fam.images(64)


def _single_steps(model, x, steps):
    """The port's single-process steps on the whole batch: ([metrics],
    [state_dict after each step], the first moments after the first
    step, the recorded draws (uniform, bernoulli) of the first step)."""
    state = TrainState(model, "cpu", seed=SEED)
    state.sampler = rec = RecordingSampler(state.sampler)
    step = make_train_step(model, LMBDA)
    history, params = [], []
    for i in range(steps):
        history.append({k: float(v) for k, v
                        in step(state, torch.from_numpy(x)).items()})
        params.append({k: v.numpy().copy()
                       for k, v in model.state_dict().items()})
        if i == 0:
            moments = tr.first_moments(state)
            draws = (list(rec.uniform_draws), list(rec.bernoulli_draws))
    return history, params, moments, draws


def _assert_metrics(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                       err_msg=k)


def _assert_params(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= PARAM_ATOL, worst


def _assert_moments(got, want):
    """Each first moment within MOMENT_RTOL of its tensor's largest
    entry."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        gap = float(np.abs(got[k] - want[k]).max())
        assert gap <= MOMENT_RTOL * scale, (k, gap, scale)


def _clipped_norm(moments):
    """The global norm of the main group's gradient as the first update
    took it (after the clip)."""
    return float(np.sqrt(sum(np.sum((m / (1 - BETA1)).astype(np.float64)
                                    ** 2) for k, m in moments.items()
                             if not is_aux_parameter(k))))


def _parallel(ranks, x, tp, tmp, meanwhile=None):
    """({name: the 2-rank steps of `tr.parallel_steps`, with --tp `tp`,
    every rank's entries joined (`tr.whole`)}, {name: meanwhile[name]()
    computed here while the ranks take that name's steps}); the cnn's
    state then saved in `tmp`/ck<tp> (as best too with --tp 2) and
    restored ("round_trip")."""
    out, mine = {}, {}
    for name in ("cnn", "stf"):
        root = str(tmp / f"ck{tp}") if name == "cnn" else None
        per_rank, mine[name] = ranks.run_while(
            (meanwhile or {}).get(name), tr.parallel_steps, name, x, LMBDA,
            tp, STEPS[name], config=CONFIG[name], root=root, best=tp > 1,
            timeout=120)
        run = dict(per_rank[0])
        run["params"] = [tr.whole([r["params"][i] for r in per_rank])
                         for i in range(STEPS[name])]
        run["moments"] = tr.whole([r["moments"] for r in per_rank])
        assert [r["metrics"] for r in per_rank[1:]] == [run["metrics"]]
        if root is not None:
            run["round_trip"] = [r["round_trip"] for r in per_rank]
            run["root"] = root
        out[name] = run
    return out, mine


@pytest.fixture(scope="module")
def ddp_single(ranks, x, tmp_path_factory):
    """(the 2-rank DDP steps (`_parallel`), {name: the single-process
    port steps})."""
    def single(name):
        return lambda: _single_steps(tr.port_model(name, **CONFIG[name]), x,
                                     STEPS[name])

    return _parallel(ranks, x, 1, tmp_path_factory.mktemp("ddp"),
                     {name: single(name) for name in CONFIG})


@pytest.fixture(scope="module")
def single(ddp_single):
    return ddp_single[1]


@pytest.fixture(scope="module")
def ddp(ddp_single):
    return ddp_single[0]


@pytest.fixture(scope="module")
def tp2_jax(ranks, x, single, tmp_path_factory):
    """(the 2-rank --tp 2 steps (`_parallel`): every parameter and both
    Adams' moments sharded over the 2-rank `model` dim (fully_shard);
    JAX's data-parallel step of the tiny cnn (`_jax_data_parallel`),
    computed while the ranks take the cnn's)."""
    out, mine = _parallel(ranks, x, 2, tmp_path_factory.mktemp("tp"),
                          {"cnn": lambda: _jax_data_parallel(
                              x, *single["cnn"][3])})
    return out, mine["cnn"]


@pytest.fixture(scope="module")
def tp2(tp2_jax):
    return tp2_jax[0]


def test_create_mesh_shapes_and_errors(ranks):
    from stf_tpu_torch.parallel import create_mesh

    assert ranks.run(tr.mesh_shape, 4) == [{"data": 2}] * 2
    assert ranks.run(tr.mesh_shape, 4, 2) == [{"data": 1, "model": 2}] * 2
    for msg in ranks.run(tr.mesh_shape, 3):
        assert "global batch 3 does not split into 2" in msg
    for msg in ranks.run(tr.mesh_shape, 4, 4):
        assert "needs 4 ranks, have 2" in msg
    # one process: no group to build a mesh on; --tp 2 needs two ranks
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh(batch_size=2, device_type="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        create_mesh(model=2, device_type="cpu")


@pytest.mark.parametrize("split", ["train", "test"])
def test_image_folder_shards_match_jax(tmp_path, split):
    from stf_tpu.datasets import ImageFolder as JaxImageFolder
    from stf_tpu_torch.datasets import ImageFolder

    root = fam.png_folder(tmp_path, n_train=5, n_test=4, size=40)
    port = ImageFolder(root, split, (32, 32), seed=3)
    ref = JaxImageFolder(root, split, (32, 32), seed=3)
    seen = []
    for index in range(2):
        got = list(port.batches(1, epoch=1, num_workers=1,
                                shard=(index, 2)))
        want = list(ref.batches(1, epoch=1, num_workers=1,
                                shard=(index, 2)))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        seen += [g.tobytes() for g in got]
    assert len(set(seen)) == 4  # disjoint shares


def test_sampler_shards_draw_rows_of_the_global_draw():
    """Each rank's draws are its rows of the single process's draws at the
    global batch (the bottleneck's along its last axis), and every
    generator ends where the single process's does."""
    like = torch.zeros(())

    def draws(shard, batch):
        s = Sampler(torch.Generator().manual_seed(5), shard)
        return [s.uniform((batch, 3, 4, 2), like),
                s.uniform((2, 1, batch * 6), like, batch_axis=2),
                s.bernoulli(0.6, (batch, 1, 1), like),
                s.gumbel((batch, 5, 2), like),
                s.generator.get_state()]

    full = draws((0, 1), 4)
    for index in range(2):
        part = draws((index, 2), 2)
        rows = slice(2 * index, 2 * index + 2)
        torch.testing.assert_close(part[0], full[0][rows], rtol=0, atol=0)
        torch.testing.assert_close(part[1], full[1][:, :, 12 * index:
                                                    12 * index + 12],
                                   rtol=0, atol=0)
        assert torch.equal(part[2], full[2][rows])
        torch.testing.assert_close(part[3], full[3][rows], rtol=0, atol=0)
        assert torch.equal(part[4], full[4])


@pytest.mark.parametrize("name", ["cnn", "stf"])
def test_ddp_step_matches_single_process(single, ddp, name):
    run = ddp[name]
    want_metrics, want_params, want_moments, _ = single[name]
    assert run["sharded"] == 0
    _assert_metrics(run["metrics"], want_metrics)
    _assert_moments(run["moments"], want_moments)
    _assert_params(run["params"][-1], want_params[-1])
    # the clip was active: the moments carry the clipped norm (1)
    np.testing.assert_allclose(_clipped_norm(want_moments), 1.0, rtol=1e-5)
    # the steps moved the parameters: two untouched models would agree
    before = tr.port_model(name, **CONFIG[name]).state_dict()
    assert any(not np.array_equal(run["params"][-1][k], before[k].numpy())
               for k in before)


@pytest.mark.parametrize("name", ["cnn", "stf"])
def test_tp_step_matches_ddp(ddp, tp2, name):
    """--tp 2: every parameter and both Adams' moments sharded, the
    gradient clipped through its shards; the step is the DDP step."""
    run = tp2[name]
    assert run["sharded"] == len(list(tr.port_model(name, **CONFIG[name])
                                      .parameters()))
    _assert_metrics(run["metrics"], ddp[name]["metrics"])
    _assert_moments(run["moments"], ddp[name]["moments"])
    _assert_params(run["params"][-1], ddp[name]["params"][-1])


def _jax_first_moments(opt_state):
    """Adam's first moment of every parameter of JAX's optimizer state
    (the main and aux Adams each hold the other's parameters as masked
    nodes), as a params tree."""
    def kind(s):
        return type(s).__name__

    adams = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: kind(s) == "ScaleByAdamState")
        if kind(s) == "ScaleByAdamState"]
    assert len(adams) == 2, [kind(s) for s in adams]
    masked = lambda m: kind(m) == "MaskedNode"  # noqa: E731
    return jax.tree_util.tree_map(
        lambda a, b: np.asarray(b if masked(a) else a),
        adams[0].mu, adams[1].mu, is_leaf=masked)


def _jax_data_parallel(x, uniforms, bernoullis):
    """JAX's data-parallel step of the tiny cnn (`port_model("cnn",
    **TINY)`'s weights) on the 8-device CPU mesh, its data axis shrunk to
    the batch of 2, fed the recorded draws (`_torch_replay`): (its
    metrics, the parameters after the update and Adam's first moments,
    as the port's state_dicts)."""
    from stf_tpu.models import WACNN as JaxWACNN
    from stf_tpu.parallel import (
        create_mesh,
        make_parallel_train_step,
        shard_batch,
    )
    from stf_tpu.training import make_train_step as jax_train_step
    from stf_tpu.training.state import TrainState as JaxTrainState
    from stf_tpu.training.state import configure_optimizers
    from stf_tpu_torch.zoo import state_dict_from_jax

    model, jparams = to_jax("cnn", tr.port_model("cnn", **TINY),
                            model=JaxWACNN(**TINY))
    state = JaxTrainState.create(apply_fn=model.apply, params=jparams,
                                 tx=configure_optimizers(1e-4, 1e-3, 1.0))
    mesh = create_mesh(batch_size=2)
    assert mesh.devices.size == 2
    step = make_parallel_train_step(jax_train_step(model, LMBDA), mesh)
    with pytest.MonkeyPatch.context() as mp:
        queues = replay_draws(mp, uniforms, bernoullis)
        state, m = step(state, shard_batch(x, mesh), jax.random.key(0))
    assert not any(queues), "the JAX step drew fewer values than the port"

    def as_port(tree):
        return {k: v.numpy() for k, v in state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, tree), "cnn").items()}

    return ({k: float(v) for k, v in m.items()}, as_port(state.params),
            as_port(_jax_first_moments(state.opt_state)))


def test_two_rank_cnn_step_matches_jax_data_parallel(ddp, tp2_jax):
    """The 2-rank DDP step of the tiny cnn against JAX's data-parallel
    step (`_jax_data_parallel`) at the same weights, the JAX step fed the
    port's draws of the single-process step, which the ranks' rows are
    (test_sampler_shards_draw_rows_of_the_global_draw): the metrics, the
    first moments and the parameters after the update."""
    run = ddp["cnn"]
    want_metrics, want_params, want_moments = tp2_jax[1]
    for k in ("loss", "bpp_loss", "distortion", "aux_loss"):
        np.testing.assert_allclose(run["metrics"][0][k], want_metrics[k],
                                   rtol=METRIC_RTOL, err_msg=k)
    _assert_params({k: run["params"][0][k] for k in want_params},
                   want_params)
    _assert_moments({k: run["moments"][k] for k in want_moments},
                    want_moments)


@pytest.mark.parametrize("tp", [1, 2])
def test_sharded_checkpoint_restores_bit_equal(request, tp):
    """The collective save after the cnn's steps (DDP, or every tensor
    sharded with --tp 2, saved as best too), restored into a fresh model,
    mesh and TrainState: model, both optimizers, schedule, generator and
    step bit-equal; the meta; the params sidecars equal to the restored
    parameters and read by the zoo."""
    from stf_tpu_torch.zoo import load_checkpoint

    run = request.getfixturevalue({1: "ddp", 2: "tp2"}[tp])["cnn"]
    root, out = run["root"], run["round_trip"]
    for equal, meta, _, _ in out:
        assert equal
        assert meta == {"model": "cnn", "lmbda": LMBDA, "metric": "mse",
                        "epoch": 3, "loss": 1.5, "best_loss": 1.25}
    restored = tr.whole([r[3] for r in out])
    # restored, not merely reloaded: the state after the steps
    for k in restored:
        np.testing.assert_array_equal(restored[k], run["params"][-1][k],
                                      err_msg=k)
    sidecars = ["params.pth.tar"] + (["params_best.pth.tar"] if tp > 1
                                     else [])
    assert sorted(os.listdir(root)) == sorted(
        (["best"] if tp > 1 else []) + ["latest"]
        + [f for s in sidecars for f in (s, s + ".json")])
    for s in sidecars:
        sidecar = out[0][2][s]
        assert set(sidecar) == set(restored)
        for k in restored:
            np.testing.assert_array_equal(sidecar[k], restored[k],
                                          err_msg=k)
        # the zoo's format: its json names the model, the small config
        # is passed as the model's kwargs
        got = load_checkpoint(os.path.join(root, s), device="cpu",
                              **TINY).state_dict()
        for k in restored:
            np.testing.assert_array_equal(got[k].numpy(), restored[k],
                                          err_msg=k)


def test_trainer_cli_sharded_format_and_resume(ranks, tmp_path):
    """`train.main` on two ranks with --ckpt-format sharded: an epoch, then
    a resume from the save directory for a second; and the start-up
    refusal of --tp 2 with the single-file format."""
    root = fam.png_folder(tmp_path, n_train=4, n_test=2, size=72)
    save = str(tmp_path / "save")
    argv = ["-m", "cnn_small_test", "-d", root, "--batch-size", "2",
            "--test-batch-size", "2", "--patch-size", "64", "64",
            "--num-workers", "1", "--device", "cpu", "--save-dir", save,
            "--ckpt-format", "sharded"]
    small = {"cnn_small_test": ("cnn", TINY)}
    first = ranks.run(tr.run_cli, "train", argv + ["-e", "1"], small,
                      timeout=120)
    assert [r[1:] for r in first] == [(None, 2)] * 2
    assert "Test epoch 0" in first[0][0] and first[1][0] == ""
    assert sorted(os.listdir(os.path.join(save, "latest"))) == ["0"]
    second = ranks.run(tr.run_cli, "train",
                       argv + ["-e", "2", "--checkpoint", save], small,
                       timeout=120)
    assert [r[1:] for r in second] == [(None, 4)] * 2
    assert f"resumed from {save} at epoch 1" in second[0][0]
    assert sorted(os.listdir(os.path.join(save, "latest"))) == ["0", "1"]
    refused = ranks.run(tr.run_cli, "train",
                        argv[:-2] + ["-e", "1", "--tp", "2"], small)
    for _, msg, _ in refused:
        assert "requires --ckpt-format sharded" in msg


def test_dytrain_step_two_ranks_match_one(ranks, x):
    """The distillation step with the student under DDP and the teacher
    replicated (two steps: DDP checks in the second that every student
    parameter took a gradient in the first) against the single-process
    step (clf_weight 1; Gumbel, noise and DropPath draws the rows of the
    global draws): the parts of both steps, the first moments after the
    first, the parameters after both."""
    def single_steps():
        student, teacher = tr.distill_pair()
        state = TrainState(student, "cpu", seed=SEED)
        step = make_dytrain_step(student, teacher, LMBDA, KEEP,
                                 clf_weight=1.0)
        parts, moments = [], None
        for _ in range(2):
            parts.append({k: float(v) for k, v
                          in step(state, torch.from_numpy(x)).items()})
            moments = moments or tr.first_moments(state)
        return parts, moments, {k: v.numpy()
                                for k, v in student.state_dict().items()}

    per_rank, (want, want_moments, want_params) = ranks.run_while(
        single_steps, tr.dytrain_steps, x, LMBDA, KEEP, 2, timeout=120)
    parts, _, moments = per_rank[0]
    _assert_metrics(parts, want)
    _assert_moments(moments, want_moments)
    _assert_params(tr.whole([r[1] for r in per_rank]), want_params)
