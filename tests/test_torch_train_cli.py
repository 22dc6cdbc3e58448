"""The port's trainer CLI (`python -m stf_tpu_torch.training.train`) on
the CPU: two epochs of a tiny registry model on a tiny PNG folder, a
resume with a higher -e, and the checkpoint loaded strictly into a fresh
registry model and mapped to flax params (mirrors
`tests/test_train_eval_cli.py:40`)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (autouse)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(0)
    for split, n in (("train", 6), ("test", 2)):
        d = root / split
        d.mkdir()
        for i in range(n):
            arr = (rng.random((80, 80, 3)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / f"{i}.png")
    return str(root)


@pytest.fixture
def tiny_registry(monkeypatch):
    """A tiny WACNN under a test-only registry name."""
    from stf_tpu_torch.models import WACNN
    from stf_tpu_torch.zoo import models

    monkeypatch.setitem(models, "cnn_tiny_test", lambda: WACNN(
        N=16, M=24, num_slices=2, max_support_slices=1))
    return "cnn_tiny_test"


def test_train_two_epochs_resume_and_load(tiny_dataset, tiny_registry,
                                          tmp_path, capsys):
    from stf_tpu.zoo.torch_import import import_state_dict
    from stf_tpu_torch.training.checkpoint import load_checkpoint
    from stf_tpu_torch.training.train import main
    from stf_tpu_torch.zoo import create_model

    save_dir = str(tmp_path / "ckpt")
    argv = ["-m", tiny_registry, "-d", tiny_dataset, "-e", "2",
            "--batch-size", "2", "--test-batch-size", "2",
            "--patch-size", "64", "64", "--save-dir", save_dir,
            "--num-workers", "2", "--milestones", "1", "--device", "cpu"]
    state = main(argv)
    assert state.step == 2 * 3  # 6 images / batch 2 = 3 steps an epoch
    out = capsys.readouterr().out
    assert out.count("Test epoch") == 2 and "Train epoch 1: [0/6]" in out
    # the schedule's boundary is at epoch 1 = step 3
    assert "Learning rate: 1.00e-04" in out and "Learning rate: 1.00e-05" in out
    path = os.path.join(save_dir, "checkpoint.pth.tar")
    assert os.path.exists(os.path.join(save_dir, "checkpoint_best.pth.tar"))
    ckpt = load_checkpoint(path)
    assert ckpt["epoch"] == 1 and ckpt["step"] == 6
    assert (ckpt["model"], ckpt["lmbda"], ckpt["metric"]) == (
        tiny_registry, 1e-2, "mse")
    for k in ("state_dict", "loss", "optimizer", "aux_optimizer",
              "lr_scheduler", "best_loss", "generator"):
        assert k in ckpt

    state2 = main(argv[:argv.index("-e")] + ["-e", "3"]
                  + argv[argv.index("-e") + 2:] + ["--checkpoint", path])
    assert state2.step == 3 * 3
    assert "resumed from" in capsys.readouterr().out
    ckpt2 = load_checkpoint(path)
    assert ckpt2["epoch"] == 2
    assert ckpt2["best_loss"] <= ckpt["best_loss"]

    fresh = create_model(ckpt2["model"])
    fresh.load_state_dict(ckpt2["state_dict"], strict=True)
    for k, v in state2.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # the reference torch names: the JAX bridge maps every key
    import jax
    import jax.numpy as jnp
    from stf_tpu.models import WACNN as JaxWACNN

    jmodel = JaxWACNN(N=16, M=24, num_slices=2, max_support_slices=1)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), training=False))["params"]
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    params = import_state_dict("cnn", template, {
        k: v.numpy() for k, v in ckpt2["state_dict"].items()})
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert n_leaves == len(ckpt2["state_dict"])


def test_restore_resumes_every_state(tiny_dataset, tiny_registry, tmp_path):
    """A checkpoint taken mid-run restores the model, both optimizers, the
    schedule and the generator exactly: the next step from the restored
    state equals the next step of the run that saved it."""
    from stf_tpu_torch.datasets import ImageFolder
    from stf_tpu_torch.training import TrainState, make_train_step
    from stf_tpu_torch.training.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )
    from stf_tpu_torch.zoo import create_model

    batches = list(ImageFolder(tiny_dataset, "train", (64, 64)).batches(2))
    x = [torch.from_numpy(b) for b in batches]

    def trainer():
        model = create_model(tiny_registry, seed=0)
        return TrainState(model, "cpu", seed=1, lr_milestones=[2]), \
            make_train_step(model, 0.01)

    state, step = trainer()
    for b in x[:2]:
        step(state, b)
    save_checkpoint(str(tmp_path), state, 0, 1.0,
                    {"model": tiny_registry, "lmbda": 0.01, "metric": "mse"},
                    True, 1.0)
    want = step(state, x[2])

    state2, step2 = trainer()
    restore_checkpoint(str(tmp_path / "checkpoint.pth.tar"), state2)
    assert state2.step == 2 and state2.learning_rate == pytest.approx(1e-5)
    got = step2(state2, x[2])
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (k, a), b in zip(state.model.state_dict().items(),
                         state2.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_cli_defaults_to_cuda_and_raises_without_a_card(tiny_dataset):
    """Without --device the trainer targets CUDA; with no card it raises
    rather than train on the CPU."""
    from stf_tpu_torch.training.train import parse_args, resolve_device

    assert parse_args(["-d", tiny_dataset]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "stf_tpu_torch.training.train", "-d",
         tiny_dataset, "-e", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
