"""Rate-distortion training CLI (port of `stf_tpu/training/train.py`):

    python -m stf_tpu_torch.training.train -m cnn -d DATASET [--device cpu]

Recipe (reference `train.py:207-418`): Adam 1e-4 main / 1e-3 aux
(quantiles), clip-norm 1.0; lambda * 255^2 * MSE + bpp (or the ms-ssim
variant); random crops of --patch-size; the main learning rate scaled by
--lr-gamma at each of --milestones (epochs); a test epoch after every
training epoch, `checkpoint.pth.tar` each epoch and
`checkpoint_best.pth.tar` when the test loss is the lowest so far;
`--checkpoint` resumes from a saved file at its next epoch. The flags are
the JAX CLI's, without its multi-device ones (--tp, --coordinator,
--ckpt-format), plus --device (default cuda: with no card it raises
rather than train on the CPU).
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
    p.add_argument("--checkpoint", type=str, help="resume from checkpoint")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "versions of the kernels)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..datasets import ImageFolder, prefetch_to_device
    from ..zoo import create_model
    from .checkpoint import restore_checkpoint, save_checkpoint
    from .state import TrainState, make_eval_step, make_train_step

    device = resolve_device(args.device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    model = create_model(args.model, seed=args.seed)
    patch = tuple(args.patch_size)
    train_ds = ImageFolder(args.dataset, "train", patch, seed=args.seed)
    test_ds = ImageFolder(args.dataset, "test", patch, seed=args.seed)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    state = TrainState(
        model, device, seed=args.seed + 1,
        learning_rate=args.learning_rate,
        aux_learning_rate=args.aux_learning_rate,
        clip_max_norm=args.clip_max_norm,
        lr_milestones=[m * steps_per_epoch for m in args.milestones],
        lr_gamma=args.lr_gamma,
    )

    last_epoch = 0
    best_loss = float("inf")
    if args.checkpoint and os.path.exists(args.checkpoint):
        ckpt = restore_checkpoint(args.checkpoint, state)
        last_epoch = ckpt["epoch"] + 1
        best_loss = ckpt.get("best_loss", ckpt["loss"])
        print(f"resumed from {args.checkpoint} at epoch {last_epoch}")
    train_step = make_train_step(model, args.lmbda, args.metric)
    eval_step = make_eval_step(model, args.lmbda, args.metric)
    meta = {"model": args.model, "lmbda": args.lmbda, "metric": args.metric}

    for epoch in range(last_epoch, args.epochs):
        t0 = time.time()
        print(f"Learning rate: {state.learning_rate:.2e}")
        it = train_ds.batches(args.batch_size, epoch=epoch,
                              num_workers=args.num_workers)
        for i, batch in enumerate(prefetch_to_device(it, device)):
            metrics = train_step(state, batch)
            if i % args.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(
                    f"Train epoch {epoch}: [{i * args.batch_size}/"
                    f"{len(train_ds)}] "
                    f"Loss: {m['loss']:.4f} | "
                    f"Distortion: {m['distortion']:.5f} | "
                    f"Bpp: {m['bpp_loss']:.3f} | Aux: {m['aux_loss']:.1f}"
                )

        # a partial final test batch is dropped, as in the JAX trainer
        totals, count = {}, 0
        test_it = test_ds.batches(max(args.test_batch_size, 1), epoch=0,
                                  num_workers=args.num_workers)
        for batch in prefetch_to_device(test_it, device):
            for k, v in eval_step(batch).items():
                totals[k] = totals.get(k, 0.0) + float(v)
            count += 1
        if count == 0:
            print(
                "WARNING: test set yielded no full batches (test images < "
                f"{args.test_batch_size}); test loss is inf and no best "
                "checkpoint will be kept",
                file=sys.stderr,
            )
        test_loss = totals.get("loss", float("inf")) / max(count, 1)
        print(
            f"Test epoch {epoch}: loss {test_loss:.4f} "
            f"(bpp {totals.get('bpp_loss', 0) / max(count, 1):.3f}) "
            f"[{time.time() - t0:.1f}s]"
        )

        if args.save:
            is_best = test_loss < best_loss
            best_loss = min(test_loss, best_loss)
            save_checkpoint(args.save_dir, state, epoch, test_loss, meta,
                            is_best, best_loss)
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
