"""Distillation and dynamic token-pruning training for DYSTF (port of
`stf_tpu/training/dytrain.py`):

    python -m stf_tpu_torch.training.dytrain -d DATASET [--device cpu]

Loss (reference `dytrain.py:33-119`, ConvNextDistillDiffPruningLoss):
  clf_weight * RD(student)
  + ratio_weight * mean over the decisions of mean((keep share - target)^2)
  + distill_weight * KL(log_softmax(x_hat_s) || log_softmax(x_hat_t))
  + distill_weight * MSE(y_s, y_t)
The softmaxes run over the image width (axis 2 of the NHWC x_hat, the
reference's last axis of NCHW). The teacher is the model named without
the `dy` prefix, built with `is_teacher` and frozen: its eval forward runs
under `no_grad`. One backward of loss + aux feeds the port's dual Adam
(`TrainState`); the learning rate falls by 10x at each milestone epoch
(reference `dytrain.py:414`). The flags are the JAX CLI's plus --device
(default cuda: with no card it raises rather than train on the CPU).
"""

import argparse
import os
import sys
import time
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F

from ..models.codec import resolve_device
from .losses import rate_distortion_loss


def distill_pruning_loss(student_out: Dict, teacher_out: Dict,
                         batch: torch.Tensor, lmbda: float,
                         keep_ratio: Sequence[float],
                         ratio_weight: float = 10.0,
                         distill_weight: float = 0.5,
                         clf_weight: float = 0.0, metric: str = "mse"):
    """(loss, parts): the weighted sum and its terms, `loss`, `rd_loss`,
    `bpp_loss`, `pred_loss`, `cls_kl` and `token_kl`, as tensors.
    Decision i (a (B, N, 1) keep mask) is held to keep_ratio[i]."""
    rd = rate_distortion_loss(student_out, batch, lmbda, metric)
    decisions = student_out["decisions"]
    pred_loss = batch.new_zeros(())
    for i, mask in enumerate(decisions):
        pred_loss = pred_loss + torch.mean(
            (mask.mean(dim=1) - keep_ratio[i]) ** 2)
    log_s = F.log_softmax(student_out["x_hat"], dim=2)
    log_t = F.log_softmax(teacher_out["x_hat"], dim=2)
    cls_kl = torch.sum(torch.exp(log_t) * (log_t - log_s)) / batch.shape[0]
    token_kl = torch.mean((student_out["y"] - teacher_out["y"]) ** 2)
    loss = (clf_weight * rd.loss
            + ratio_weight * pred_loss / max(len(decisions), 1)
            + distill_weight * cls_kl + distill_weight * token_kl)
    return loss, {"loss": loss, "rd_loss": rd.loss, "bpp_loss": rd.bpp_loss,
                  "pred_loss": pred_loss, "cls_kl": cls_kl,
                  "token_kl": token_kl}


def distill_parts(student, teacher, batch, sampler, lmbda, keep_ratio,
                  ratio_weight=10.0, distill_weight=0.5, clf_weight=0.0):
    """(loss, parts) of the student's training forward (noise, Gumbel and
    DropPath draws from `sampler`) against the frozen teacher's eval
    forward, which runs without a graph."""
    s_out = student(batch, training=True, sampler=sampler)
    with torch.no_grad():
        t_out = teacher(batch, training=False)
    return distill_pruning_loss(s_out, t_out, batch, lmbda, keep_ratio,
                                ratio_weight, distill_weight, clf_weight)


def make_dytrain_step(student, teacher, lmbda: float,
                      keep_ratio: Sequence[float], ratio_weight: float = 10.0,
                      distill_weight: float = 0.5,
                      clf_weight: float = 0.0) -> Callable:
    """`step(state, batch)`: one distillation step of the student that
    `state` (a TrainState) trains: the loss of `distill_parts` plus the
    aux loss, one backward, one update. Returns the parts and `aux_loss`,
    detached (reading them syncs). The teacher is put in eval mode and
    its parameters stop asking for gradients."""
    teacher.eval().requires_grad_(False)

    def step(state, batch):
        student.train()
        state.zero_grad()
        loss, parts = distill_parts(
            student, teacher, batch, state.sampler, lmbda, keep_ratio,
            ratio_weight, distill_weight, clf_weight)
        aux = student.aux_loss()
        (loss + aux).backward()
        state.apply_gradients()
        parts["aux_loss"] = aux
        return {k: v.detach() for k, v in parts.items()}

    return step


def parse_args(argv):
    p = argparse.ArgumentParser(description="DYSTF distillation training "
                                "(PyTorch)")
    p.add_argument("-m", "--model", default="dystf")
    p.add_argument("-d", "--dataset", required=True)
    p.add_argument("-e", "--epochs", type=int, default=1000)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("-n", "--num-workers", type=int, default=8)
    p.add_argument("--lambda", dest="lmbda", type=float, default=1e-2)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--test-batch-size", type=int, default=16)
    p.add_argument("--aux-learning-rate", type=float, default=1e-3)
    p.add_argument("--patch-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clip_max_norm", type=float, default=1.0)
    p.add_argument("--ratio", type=str, default="0.9,0.7,0.5")
    p.add_argument("--ratio-weight", type=float, default=10.0)
    p.add_argument("--distill-weight", type=float, default=0.5)
    p.add_argument("--clf-weight", type=float, default=0.0)
    p.add_argument("--milestones", type=int, nargs="*", default=[500, 700, 900])
    p.add_argument("--save-dir", type=str, default="./ckpt_dy")
    p.add_argument("--checkpoint", type=str)
    p.add_argument("--teacher-checkpoint", type=str)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..datasets import ImageFolder, prefetch_to_device
    from ..zoo import create_model, load_checkpoint
    from .checkpoint import restore_checkpoint, save_checkpoint
    from .sampler import Sampler
    from .state import TrainState

    device = resolve_device(args.device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    student = create_model(args.model, seed=args.seed)
    # the teacher: the non-dynamic twin (the name without `dy`), from its
    # checkpoint, else seeded weights (useful only for smoke runs)
    teacher_name = args.model[2:]
    if args.teacher_checkpoint:
        teacher = load_checkpoint(args.teacher_checkpoint, teacher_name,
                                  device=device, is_teacher=True)
    else:
        teacher = create_model(teacher_name, seed=1, is_teacher=True)
    teacher = teacher.to(device)
    keep_ratio = [float(r) for r in args.ratio.split(",")]

    patch = tuple(args.patch_size)
    train_ds = ImageFolder(args.dataset, "train", patch, seed=args.seed)
    test_ds = ImageFolder(args.dataset, "test", patch, seed=args.seed)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    state = TrainState(
        student, device, seed=args.seed + 1,
        learning_rate=args.learning_rate,
        aux_learning_rate=args.aux_learning_rate,
        clip_max_norm=args.clip_max_norm,
        lr_milestones=[m * steps_per_epoch for m in args.milestones],
        lr_gamma=0.1,
    )
    last_epoch, best_loss = 0, float("inf")
    if args.checkpoint and os.path.exists(args.checkpoint):
        ckpt = restore_checkpoint(args.checkpoint, state)
        last_epoch = ckpt["epoch"] + 1
        best_loss = ckpt.get("best_loss", ckpt["loss"])
        print(f"resumed from {args.checkpoint} at epoch {last_epoch}")
    weights = (args.ratio_weight, args.distill_weight, args.clf_weight)
    step = make_dytrain_step(student, teacher, args.lmbda, keep_ratio,
                             *weights)
    meta = {"model": args.model, "lmbda": args.lmbda, "metric": "mse"}

    for epoch in range(last_epoch, args.epochs):
        t0 = time.time()
        it = train_ds.batches(args.batch_size, epoch, args.num_workers)
        for i, batch in enumerate(prefetch_to_device(it, device)):
            parts = step(state, batch)
            if i % args.log_every == 0:
                m = {k: float(v) for k, v in parts.items()}
                print(f"dytrain epoch {epoch} [{i}]: loss {m['loss']:.4f} "
                      f"rd {m['rd_loss']:.4f} pred {m['pred_loss']:.5f} "
                      f"kl {m['cls_kl']:.5f} token {m['token_kl']:.5f}")

        # the test epoch scores the student's training forward with the
        # same criterion, without a gradient (the reference's test_epoch);
        # its draws come from a generator of their own, seeded alike each
        # epoch, so the training draws do not depend on the test set
        sampler = Sampler(torch.Generator(device=device)
                          .manual_seed(args.seed + 1))
        totals, count = {}, 0
        it = test_ds.batches(args.batch_size, 0, args.num_workers)
        with torch.no_grad():
            for batch in prefetch_to_device(it, device):
                _, parts = distill_parts(student, teacher, batch, sampler,
                                         args.lmbda, keep_ratio, *weights)
                for k, v in parts.items():
                    totals[k] = totals.get(k, 0.0) + float(v)
                count += 1
        test_loss = totals.get("loss", float("inf")) / max(count, 1)
        print(f"dytrain test epoch {epoch}: loss {test_loss:.4f} "
              f"[{time.time() - t0:.1f}s]")

        is_best = test_loss < best_loss
        best_loss = min(test_loss, best_loss)
        save_checkpoint(args.save_dir, state, epoch, test_loss, meta,
                        is_best, best_loss)
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
