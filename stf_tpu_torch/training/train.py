"""Rate-distortion training CLI (port of `stf_tpu/training/train.py`):

    python -m stf_tpu_torch.training.train -m cnn -d DATASET [--device cpu]

Recipe (reference `train.py:207-418`): Adam 1e-4 main / 1e-3 aux
(quantiles), clip-norm 1.0; lambda * 255^2 * MSE + bpp (or the ms-ssim
variant); random crops of --patch-size; the main learning rate scaled by
--lr-gamma at each of --milestones (epochs); a test epoch after every
training epoch, `checkpoint.pth.tar` each epoch and
`checkpoint_best.pth.tar` when the test loss is the lowest so far;
`--checkpoint` resumes from a saved file at its next epoch. The flags are
the JAX CLI's plus --device (default cuda: with no card it raises rather
than train on the CPU).

Several processes (`stf_tpu_torch.parallel`):

    python -m torch.distributed.run --nproc_per_node N \
        -m stf_tpu_torch.training.train -m stf -d DATASET [--tp T] \
        [--ckpt-format sharded]

or, with RANK and WORLD_SIZE set in each process, `--coordinator
host:port`. Each rank trains on --batch-size / N rows (its share of the
global batch, which must split evenly) and its share of the training and
test images; DDP averages the gradients, and with `--tp T` the
parameters and both Adams' moments are sharded T ways instead
(`fully_shard`; the step is the same). The test loss is reduced over the
ranks, so every rank takes the same is_best decision. Rank 0 logs and
writes the single-file checkpoints; `--ckpt-format sharded` saves
collectively (`ShardedCheckpointer`: latest/<epoch>, best/<epoch> and the
params-only sidecars) and resumes with `--checkpoint <save-dir>`; `--tp`
> 1 on several processes requires it, as the JAX CLI requires orbax.
"""

import argparse
import os
import sys
import time

import torch

from ..models.codec import resolve_device


def parse_args(argv):
    p = argparse.ArgumentParser(description="RD training (PyTorch)")
    p.add_argument("-m", "--model", default="cnn", help="model architecture")
    p.add_argument("-d", "--dataset", required=True, help="training dataset")
    p.add_argument("-e", "--epochs", type=int, default=350)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("-n", "--num-workers", type=int, default=8)
    p.add_argument("--lambda", dest="lmbda", type=float, default=1e-2)
    p.add_argument("--metric", choices=["mse", "ms-ssim"], default="mse")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--test-batch-size", type=int, default=16)
    p.add_argument("--aux-learning-rate", type=float, default=1e-3)
    p.add_argument("--patch-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clip_max_norm", type=float, default=1.0)
    p.add_argument("--milestones", type=int, nargs="*", default=[320, 345])
    p.add_argument("--lr-gamma", type=float, default=0.1)
    p.add_argument("--save", action="store_true", default=True)
    p.add_argument("--save-dir", type=str, default="./ckpt")
    p.add_argument(
        "--ckpt-format", choices=["pth", "sharded"], default="pth",
        help="pth: rank 0 writes checkpoint.pth.tar (reference-shaped); "
        "sharded: collective asynchronous torch.distributed.checkpoint "
        "save with retention (resume with --checkpoint <save-dir>)",
    )
    p.add_argument("--checkpoint", type=str, help="resume from checkpoint")
    p.add_argument(
        "--coordinator", type=str, default=None,
        help="host:port where the ranks meet (RANK and WORLD_SIZE from the "
        "environment); unset: one process, or python -m "
        "torch.distributed.run's rendezvous",
    )
    p.add_argument(
        "--tp", type=int, default=1,
        help="ways to shard the parameters and both Adams' moments over a "
        "`model` mesh dim (fully_shard); 1 = pure data parallelism (DDP)",
    )
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
    from ..zoo import create_model
    from .checkpoint import (
        ShardedCheckpointer,
        is_sharded_checkpoint,
        restore_checkpoint,
        save_checkpoint,
    )
    from .state import TrainState, make_eval_step, make_train_step

    device = join_process_group(resolve_device(args.device), args.coordinator)
    n_proc = process_count()
    if args.tp > 1 and n_proc > 1 and args.ckpt_format != "sharded":
        # a single-file save would gather the whole sharded state on rank
        # 0 at the first epoch's end, after an epoch of compute: refuse at
        # start-up, as the JAX CLI does
        raise SystemExit(
            "--tp > 1 on several processes requires --ckpt-format sharded "
            "(collective sharded saves); the single-file format holds the "
            "whole state on rank 0")
    mesh = (create_mesh(batch_size=args.batch_size, model=args.tp,
                        device_type=device.type)
            if is_initialized() or args.tp > 1 else None)
    shard = data_parallel_shardings(mesh) if mesh is not None else (0, 1)
    main_proc = is_main_process()
    log = print if main_proc else (lambda *a, **k: None)
    log(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else "")
        + f", processes: {n_proc}")

    model = create_model(args.model, seed=args.seed).to(device)
    forward = parallelize(model, mesh) if mesh is not None else model
    patch = tuple(args.patch_size)
    train_ds = ImageFolder(args.dataset, "train", patch, seed=args.seed)
    test_ds = ImageFolder(args.dataset, "test", patch, seed=args.seed)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    # built after `parallelize`: a sharded model's optimizers hold its
    # sharded parameters
    state = TrainState(
        model, device, seed=args.seed + 1,
        learning_rate=args.learning_rate,
        aux_learning_rate=args.aux_learning_rate,
        clip_max_norm=args.clip_max_norm,
        lr_milestones=[m * steps_per_epoch for m in args.milestones],
        lr_gamma=args.lr_gamma, shard=shard,
    )
    ckpt = (ShardedCheckpointer(args.save_dir)
            if args.save and args.ckpt_format == "sharded" else None)

    last_epoch = 0
    best_loss = float("inf")
    if args.checkpoint and os.path.exists(args.checkpoint):
        if is_sharded_checkpoint(args.checkpoint):
            own = ckpt is not None and os.path.samefile(args.checkpoint,
                                                        args.save_dir)
            # a foreign run's directory is only read
            reader = ckpt if own else ShardedCheckpointer(args.checkpoint,
                                                          read_only=True)
            meta = reader.restore(state)
        elif args.tp > 1:
            raise SystemExit("a --tp run resumes from a sharded checkpoint "
                             "(--checkpoint <save-dir>)")
        else:
            meta = restore_checkpoint(args.checkpoint, state)
        last_epoch = meta["epoch"] + 1
        best_loss = meta.get("best_loss", meta["loss"])
        log(f"resumed from {args.checkpoint} at epoch {last_epoch}")
    train_step = make_train_step(forward, args.lmbda, args.metric)
    if mesh is not None:
        train_step = make_parallel_train_step(train_step)
    # each rank scores its own rows (a sharded model gathers its
    # parameters in the wrapper's forward)
    eval_step = make_eval_step(forward, args.lmbda, args.metric)
    meta = {"model": args.model, "lmbda": args.lmbda, "metric": args.metric}
    local_batch = args.batch_size // n_proc
    # a partial final test batch is dropped, as in the JAX trainer
    local_test_batch = max(args.test_batch_size // n_proc, 1)

    try:
        for epoch in range(last_epoch, args.epochs):
            t0 = time.time()
            log(f"Learning rate: {state.learning_rate:.2e}")
            it = train_ds.batches(local_batch, epoch=epoch,
                                  num_workers=args.num_workers, shard=shard)
            for i, batch in enumerate(prefetch_to_device(it, device)):
                metrics = train_step(state, batch)
                if i % args.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    log(f"Train epoch {epoch}: [{i * args.batch_size}/"
                        f"{len(train_ds)}] "
                        f"Loss: {m['loss']:.4f} | "
                        f"Distortion: {m['distortion']:.5f} | "
                        f"Bpp: {m['bpp_loss']:.3f} | Aux: {m['aux_loss']:.1f}")

            # every rank scores its share of the test set; the sums are
            # averaged over the ranks (equal shares), so the loss, and the
            # is_best decision the collective save depends on, agree
            totals, count = {}, 0
            test_it = test_ds.batches(local_test_batch, epoch=0,
                                      num_workers=args.num_workers,
                                      shard=shard)
            for batch in prefetch_to_device(test_it, device):
                for k, v in eval_step(batch).items():
                    totals[k] = totals.get(k, 0.0) + v.double()
                count += 1
            totals = {k: float(v) for k, v in mean_over_ranks(totals).items()}
            if count == 0:
                log("WARNING: test set yielded no full batches (test images "
                    f"per process < {local_test_batch}); test loss is inf "
                    "and no best checkpoint will be kept", file=sys.stderr)
            test_loss = totals.get("loss", float("inf")) / max(count, 1)
            log(f"Test epoch {epoch}: loss {test_loss:.4f} "
                f"(bpp {totals.get('bpp_loss', 0) / max(count, 1):.3f}) "
                f"[{time.time() - t0:.1f}s]")

            if args.save:
                is_best = test_loss < best_loss
                best_loss = min(test_loss, best_loss)
                if ckpt is not None:
                    # collective: each rank writes the shards it holds
                    ckpt.save(state, epoch, test_loss, meta, is_best,
                              best_loss)
                elif main_proc:
                    save_checkpoint(args.save_dir, state, epoch, test_loss,
                                    meta, is_best, best_loss)
            sync_global_devices()
    finally:
        # an exception mid-epoch must not abandon a save in flight
        if ckpt is not None:
            ckpt.close()
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
