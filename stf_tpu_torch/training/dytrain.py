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
Under `python -m torch.distributed.run --nproc_per_node N` the student
trains under DDP on --batch-size / N rows a rank, the frozen teacher
replicated beside it, the Gumbel, noise and DropPath draws each rank's
rows of the global batch's (`Sampler`); rank 0 logs and saves, as the
JAX CLI's data mesh does (`stf_tpu/training/dytrain.py:142-148`).
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
from .state import as_train_forward


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
    """(loss, parts, aux) of the student's training forward (noise, Gumbel
    and DropPath draws from `sampler`) against the frozen teacher's eval
    forward, which runs without a graph. `student` is the model or its
    training forward (`as_train_forward`), e.g. the student under DDP
    (`parallel.parallelize`)."""
    s_out, aux = as_train_forward(student)(batch, sampler=sampler)
    with torch.no_grad():
        t_out = teacher(batch, training=False)
    loss, parts = distill_pruning_loss(s_out, t_out, batch, lmbda,
                                       keep_ratio, ratio_weight,
                                       distill_weight, clf_weight)
    return loss, parts, aux


def make_dytrain_step(student, teacher, lmbda: float,
                      keep_ratio: Sequence[float], ratio_weight: float = 10.0,
                      distill_weight: float = 0.5,
                      clf_weight: float = 0.0) -> Callable:
    """`step(state, batch)`: one distillation step of the student that
    `state` (a TrainState) trains: the loss of `distill_parts` plus the
    aux loss, one backward, one update. Returns the parts and `aux_loss`,
    detached (reading them syncs). The teacher is put in eval mode and
    its parameters stop asking for gradients. With the student's
    parallel wrapper (`parallel.parallelize`) each rank trains on its
    rows, the teacher replicated beside it
    (`parallel.make_parallel_train_step` averages the parts over the
    ranks)."""
    teacher.eval().requires_grad_(False)
    forward = as_train_forward(student)

    def step(state, batch):
        forward.train()
        state.zero_grad()
        loss, parts, aux = distill_parts(
            forward, teacher, batch, state.sampler, lmbda, keep_ratio,
            ratio_weight, distill_weight, clf_weight)
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
    from ..parallel import (
        create_mesh,
        data_parallel_shardings,
        is_initialized,
        is_main_process,
        join_process_group,
        make_parallel_train_step,
        mean_over_ranks,
        parallelize,
        process_count,
        sync_global_devices,
    )
    from ..zoo import create_model, load_checkpoint
    from .checkpoint import restore_checkpoint, save_checkpoint
    from .sampler import Sampler
    from .state import TrainState

    # several ranks (python -m torch.distributed.run): the student under
    # DDP on each rank's share of the batch, the teacher replicated
    device = join_process_group(resolve_device(args.device))
    mesh = (create_mesh(batch_size=args.batch_size, device_type=device.type)
            if is_initialized() else None)
    shard = data_parallel_shardings(mesh) if mesh is not None else (0, 1)
    main_proc = is_main_process()
    log = print if main_proc else (lambda *a, **k: None)
    log(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else ""))
    student = create_model(args.model, seed=args.seed).to(device)
    forward = parallelize(student, mesh) if mesh is not None else student
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
        lr_gamma=0.1, shard=shard,
    )
    last_epoch, best_loss = 0, float("inf")
    if args.checkpoint and os.path.exists(args.checkpoint):
        ckpt = restore_checkpoint(args.checkpoint, state)
        last_epoch = ckpt["epoch"] + 1
        best_loss = ckpt.get("best_loss", ckpt["loss"])
        log(f"resumed from {args.checkpoint} at epoch {last_epoch}")
    weights = (args.ratio_weight, args.distill_weight, args.clf_weight)
    step = make_dytrain_step(forward, teacher, args.lmbda, keep_ratio,
                             *weights)
    if mesh is not None:
        step = make_parallel_train_step(step)
    meta = {"model": args.model, "lmbda": args.lmbda, "metric": "mse"}
    local_batch = args.batch_size // process_count()

    for epoch in range(last_epoch, args.epochs):
        t0 = time.time()
        it = train_ds.batches(local_batch, epoch, args.num_workers,
                              shard=shard)
        for i, batch in enumerate(prefetch_to_device(it, device)):
            parts = step(state, batch)
            if i % args.log_every == 0:
                m = {k: float(v) for k, v in parts.items()}
                log(f"dytrain epoch {epoch} [{i}]: loss {m['loss']:.4f} "
                    f"rd {m['rd_loss']:.4f} pred {m['pred_loss']:.5f} "
                    f"kl {m['cls_kl']:.5f} token {m['token_kl']:.5f}")

        # the test epoch scores the student's training forward with the
        # same criterion, without a gradient (the reference's test_epoch);
        # its draws come from a generator of their own, seeded alike each
        # epoch, so the training draws do not depend on the test set; the
        # ranks' sums are averaged (equal shares)
        sampler = Sampler(torch.Generator(device=device)
                          .manual_seed(args.seed + 1), shard)
        totals, count = {}, 0
        it = test_ds.batches(local_batch, 0, args.num_workers, shard=shard)
        with torch.no_grad():
            for batch in prefetch_to_device(it, device):
                _, parts, _ = distill_parts(forward, teacher, batch, sampler,
                                            args.lmbda, keep_ratio, *weights)
                for k, v in parts.items():
                    totals[k] = totals.get(k, 0.0) + v.double()
                count += 1
        totals = {k: float(v) for k, v in mean_over_ranks(totals).items()}
        test_loss = totals.get("loss", float("inf")) / max(count, 1)
        log(f"dytrain test epoch {epoch}: loss {test_loss:.4f} "
            f"[{time.time() - t0:.1f}s]")

        is_best = test_loss < best_loss
        best_loss = min(test_loss, best_loss)
        if main_proc:
            save_checkpoint(args.save_dir, state, epoch, test_loss, meta,
                            is_best, best_loss)
        sync_global_devices()
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
