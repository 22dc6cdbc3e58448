"""Gate-Decorator ("tick-tock") channel-pruning training for CC_GD (port of
`stf_tpu/training/train_gd.py`):

    python -m stf_tpu_torch.training.train_gd -d DATASET [--device cpu]

  * "tock" epochs: RD loss + `sparse_lambda` * sum |gate| over every gate,
    plus the aux loss, on the dual Adam (reference `train_gd.py:134-137`);
  * every `tick_freq` epochs a "tick": `tick_round` rounds, each over a
    `subset_scale` share of the training batches, of the RD loss's
    gradient with respect to the gates alone; each batch adds the Taylor
    score |dL/dgate * gate| of every channel and takes one step of a
    fresh Adam over the gates (no other parameter or buffer moves); each
    round then zeroes the masks of the globally lowest-scoring channels
    (`prune_masks`, reference `train_gd.py:161-237`);
  * training stops after a tick that leaves `param_scale` (the kept share
    of the gated channels) under `flops_target`;
  * `prune_export` folds every gate into its producing convolution and
    cuts the pruned channels out of it and of every consumer
    (`train_gd.py:507-565`), writing `pruned_model.pth.tar` and its
    `.deps.json` sidecar, which `zoo.load_checkpoint` reads back into
    `CC_GD(deps=...)`.

Gates are named by the JAX package's paths, "<stack>/gate_<i>" (stack
h_a, h_mean_s, h_scale_s, cc_mean_<j>, cc_scale_<j> or lrp_<j>; i the
gate's conv in the stack). The port's GateDecorator keeps `gate` as a
(1, C, 1, 1) parameter and `mask` as a buffer, so the main Adam never
sees a mask. Weight layouts are torch's: Conv2d (out, in, kh, kw),
ConvTranspose2d (in, out, kh, kw), so a producer's output channels are
axis 0 of a convolution and axis 1 of a transposed one, and a consumer's
input channels the other axis.
"""

import argparse
import json
import os
import sys
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.cc_gd import GateDecorator
from ..models.codec import resolve_device
from .losses import rate_distortion_loss

PRUNED_MODEL = "pruned_model.pth.tar"
# the state_dict names of the slice-stack lists, by their JAX stack prefix
_SLICE_LISTS = {"cc_mean_transforms": "cc_mean",
                "cc_scale_transforms": "cc_scale", "lrp_transforms": "lrp"}
_HYPER = ("h_a", "h_mean_s", "h_scale_s")
# every gated stack has three convs; a gate after the last one feeds
# another module
_LAST = 2


def _gate_sites(model: nn.Module):
    """(JAX stack name, gate index i, state_dict prefix of the stack's
    Sequential, GateDecorator) of every gate, in module order: gate i sits
    at Sequential index 3i + 1, after conv i. `h_a.4` is ("h_a", 1, "h_a"),
    `lrp_transforms.3.1` ("lrp_3", 0, "lrp_transforms.3")."""
    for name, m in model.named_modules():
        if isinstance(m, GateDecorator):
            prefix, idx = name.rsplit(".", 1)
            parts = prefix.split(".")
            stack = (parts[0] if parts[0] in _HYPER
                     else f"{_SLICE_LISTS[parts[0]]}_{parts[1]}")
            yield stack, (int(idx) - 1) // 3, prefix, m


def iter_gates(model: nn.Module) -> Iterator[Tuple[str, GateDecorator]]:
    """(JAX path "<stack>/gate_<i>", GateDecorator) of every gate, in
    module order."""
    for stack, i, _, m in _gate_sites(model):
        yield f"{stack}/gate_{i}", m


def gate_l1_penalty(model: nn.Module) -> torch.Tensor:
    """sum |gate| over every gate."""
    return sum(g.gate.abs().sum() for _, g in iter_gates(model))


def accumulate_scores(scores: Dict[str, np.ndarray], model: nn.Module,
                      grads: Dict[str, torch.Tensor]):
    """scores[path] + |dL/dgate * gate| per channel, as (C,) f32 NumPy
    arrays (the Taylor importance); `grads` maps gate paths to their
    gradients. Returns a new dict."""
    out = {}
    for path, g in iter_gates(model):
        if path in grads:
            s = (grads[path] * g.gate).abs().detach().reshape(-1).cpu().numpy()
            out[path] = scores.get(path, 0.0) + s
    return out


def prune_masks(model: nn.Module, scores: Dict[str, np.ndarray],
                num: int = 5, minimal_frac: float = 0.04):
    """Zero the masks of the globally lowest-scoring alive channels, in
    place: the threshold is the num-th lowest score among the channels
    whose mask is on (ties at it are pruned together); in each gate the
    max(int(minimal_frac * C), 1) best-scoring channels (over all of its
    channels) are kept whatever the threshold."""
    gates = [(p, g) for p, g in iter_gates(model) if p in scores]
    if not gates or num <= 0:
        return
    alive = [scores[p][g.mask.reshape(-1).cpu().numpy() > 0]
             for p, g in gates]
    flat = np.sort(np.concatenate(alive))
    threshold = flat[min(num, len(flat)) - 1]
    with torch.no_grad():
        for p, g in gates:
            s = scores[p]
            minimal = max(int(minimal_frac * s.size), 1)
            keep = (s >= np.sort(s)[-minimal]) | (s > threshold)
            g.mask.mul_(torch.from_numpy(keep.astype(np.float32))
                        .reshape(g.mask.shape).to(g.mask.device))


def make_gate_optimizer(model: nn.Module, learning_rate: float):
    """The tick's optimizer: a fresh Adam over the gates only, so no other
    parameter or buffer can move (the JAX package's `make_gate_tx`, whose
    `multi_transform` zeroes every other update)."""
    return torch.optim.Adam([g.gate for _, g in iter_gates(model)],
                            lr=learning_rate)


def param_scale(model: nn.Module) -> float:
    """The kept share of the gated channels, weighted by gate width (the
    pruned model's parameter scale, the stop rule's measure)."""
    kept = total = 0
    for _, g in iter_gates(model):
        kept += int((g.mask > 0).sum())
        total += g.mask.numel()
    return kept / total if total else 1.0


def make_gd_train_step(model: nn.Module, lmbda: float,
                       sparse_lambda: float):
    """`step(state, batch)`: one tock step, RD + sparse_lambda * L1 of the
    gates + aux, one backward, one update of the dual Adam. Returns
    `loss` (the RD loss), `bpp_loss` and `aux`, detached."""

    def step(state, batch):
        model.train()
        state.zero_grad()
        out = model(batch, training=True, sampler=state.sampler)
        rd = rate_distortion_loss(out, batch, lmbda)
        aux = model.aux_loss()
        (rd.loss + sparse_lambda * gate_l1_penalty(model) + aux).backward()
        state.apply_gradients()
        return {"loss": rd.loss.detach(), "bpp_loss": rd.bpp_loss.detach(),
                "aux": aux.detach()}

    return step


def tick_grads(model: nn.Module, batch, lmbda: float, sampler):
    """{gate path: dL/dgate} of the RD loss of one training forward."""
    gates = list(iter_gates(model))
    model.train()
    out = model(batch, training=True, sampler=sampler)
    loss = rate_distortion_loss(out, batch, lmbda).loss
    grads = torch.autograd.grad(loss, [g.gate for _, g in gates])
    return {p: gr for (p, _), gr in zip(gates, grads)}


def tick(model: nn.Module, batches, lmbda: float, sampler, rounds: int,
         num: int, learning_rate: float):
    """One tick: `rounds` rounds over the batches `batches()` yields, each
    accumulating scores and stepping the gates' Adam batch by batch (the
    scores read the gates before the step), then pruning `num` channels
    by `prune_masks`. The Adam lives for the whole tick."""
    opt = make_gate_optimizer(model, learning_rate)
    gates = dict(iter_gates(model))
    for _ in range(rounds):
        scores = {}
        for batch in batches():
            grads = tick_grads(model, batch, lmbda, sampler)
            scores = accumulate_scores(scores, model, grads)
            for p, gr in grads.items():
                gates[p].gate.grad = gr
            opt.step()
        prune_masks(model, scores, num)
    opt.zero_grad(set_to_none=True)


# -- the pruned export ---------------------------------------------------------

def _fold_gate(sd: Dict[str, torch.Tensor], model: nn.Module, prefix: str,
               i: int) -> torch.Tensor:
    """Fold gate i of the stack at `prefix` into its producer (conv i, at
    Sequential index 3i), keep the channels whose mask is on, drop the
    gate; returns the kept indices."""
    gate = sd.pop(f"{prefix}.{3 * i + 1}.gate").reshape(-1)
    mask = sd.pop(f"{prefix}.{3 * i + 1}.mask").reshape(-1)
    keep = torch.nonzero(mask > 0).reshape(-1)
    conv = f"{prefix}.{3 * i}"
    w, b = f"{conv}.weight", f"{conv}.bias"
    if _is_deconv(model, conv):  # (in, out, kh, kw)
        sd[w] = (sd[w] * gate.reshape(1, -1, 1, 1))[:, keep]
    else:  # (out, in, kh, kw)
        sd[w] = (sd[w] * gate.reshape(-1, 1, 1, 1))[keep]
    sd[b] = (sd[b] * gate)[keep]
    return keep


def _is_deconv(model: nn.Module, name: str) -> bool:
    return isinstance(model.get_submodule(name), nn.ConvTranspose2d)


def _slice_in(sd: Dict[str, torch.Tensor], model: nn.Module, conv: str,
              keep: torch.Tensor, total: Optional[int] = None):
    """Keep only the `keep` input channels of the consumer `conv`'s
    weight; with `total`, only its first `total` input channels belong to
    the producer (the slice stacks' concat: hyper channels first, then the
    support slices), and the rest stay."""
    key = f"{conv}.weight"
    w = sd[key]
    axis = 0 if _is_deconv(model, conv) else 1
    head = w.index_select(axis, keep)
    if total is not None:
        head = torch.cat([head, w.narrow(axis, total, w.shape[axis] - total)],
                         axis)
    sd[key] = head


def widths(model) -> dict:
    """A CC_GD's constructor widths, which a pruned export's reload needs
    beside its deps."""
    return {"N": model.N, "M": model.M, "num_slices": model.num_slices,
            "max_support_slices": model.max_support_slices}


def prune_export(model: nn.Module, save_path: str):
    """Physically prune a gated CC_GD (`prune_export` of the JAX package,
    whose docstring sets out the cross-module consumers): each gate's
    gate * mask folded into its producer, the masked output channels cut
    from it and the matching input channels from every consumer:
      * an interior gate (not its stack's last conv's): the next conv;
      * h_a/gate_2 (z): the bottleneck's per-channel parameters (axis 0)
        and both hyper synthesis stacks' first transposed convolution. Not
        exact: the eval forward rounds z around each channel's median, so
        a masked z channel is not a removed one;
      * h_mean_s/gate_2: the first M input channels of every cc_mean and
        lrp stack's first conv; h_scale_s/gate_2: every cc_scale's.
    Writes `save_path/pruned_model.pth.tar` (the ungated state_dict at the
    kept widths, `CC_GD(deps=...)`'s) and its `.deps.json` sidecar
    {"deps": {gate path: kept}, "model_kwargs": the model's `widths`}.
    Returns (state_dict, deps)."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    deps = {}
    last = {}  # stack -> its prefix, where its last conv is gated
    # interior gates: the consumer is the next conv of the same stack
    for stack, i, prefix, _ in list(_gate_sites(model)):
        if i == _LAST:
            last[stack] = prefix  # cross-module, below
            continue
        keep = _fold_gate(sd, model, prefix, i)
        _slice_in(sd, model, f"{prefix}.{3 * (i + 1)}", keep)
        deps[f"{stack}/gate_{i}"] = int(keep.numel())
    # h_a's last gate: the bottleneck's channels
    if "h_a" in last:
        keep = _fold_gate(sd, model, "h_a", _LAST)
        deps["h_a/gate_2"] = int(keep.numel())
        for k in list(sd):
            if k.startswith("entropy_bottleneck."):
                sd[k] = sd[k][keep]
        for hyper in ("h_mean_s", "h_scale_s"):
            _slice_in(sd, model, f"{hyper}.0", keep)
    # the hyper synthesis stacks' last gates: the slice stacks' first M
    # input channels
    for hyper, lists in (("h_mean_s", ("cc_mean_transforms",
                                       "lrp_transforms")),
                         ("h_scale_s", ("cc_scale_transforms",))):
        if hyper not in last:
            continue
        keep = _fold_gate(sd, model, hyper, _LAST)
        deps[f"{hyper}/gate_2"] = int(keep.numel())
        for name in lists:
            for j in range(len(getattr(model, name))):
                _slice_in(sd, model, f"{name}.{j}.0", keep, total=model.M)

    os.makedirs(save_path, exist_ok=True)
    out = os.path.join(save_path, PRUNED_MODEL)
    torch.save(sd, out)
    with open(out + ".deps.json", "w") as f:
        json.dump({"deps": deps, "model_kwargs": widths(model)}, f)
    return sd, deps


def load_pruned_checkpoint(path: str, device=None):
    """The `prune_export` file at `path` (its `.deps.json` beside it) as
    the ungated `CC_GD(deps=...)` at the pruned widths, loaded strictly,
    in eval mode on `device` (`zoo.load_checkpoint`)."""
    from ..zoo import load_checkpoint

    return load_checkpoint(path, "cc_gd", device=device)


# -- the CLI ---------------------------------------------------------------------

def parse_args(argv):
    p = argparse.ArgumentParser(description="Gate-decorator pruning training "
                                "(PyTorch)")
    p.add_argument("-m", "--model", default="cc_gd")
    p.add_argument("-d", "--dataset", required=True)
    p.add_argument("-e", "--epochs", type=int, default=400)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-4)
    p.add_argument("-n", "--num-workers", type=int, default=8)
    p.add_argument("--lambda", dest="lmbda", type=float, default=1e-2)
    p.add_argument("--sparse-lambda", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--patch-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clip_max_norm", type=float, default=1.0)
    p.add_argument("--aux-learning-rate", type=float, default=1e-3)
    p.add_argument("--tick-freq", type=int, default=10)
    p.add_argument("--tick-round", type=int, default=10)
    p.add_argument("--tick-num", type=int, default=5)
    p.add_argument("--subset-scale", type=float, default=0.1)
    p.add_argument("--flops-target", type=float, default=0.5)
    p.add_argument("--save-dir", type=str, default="./ckpt_gd")
    p.add_argument("--checkpoint", type=str)
    p.add_argument("--pretrained", type=str)
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
    from .state import TrainState

    device = resolve_device(args.device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    model = create_model(args.model, seed=args.seed)
    patch = tuple(args.patch_size)
    train_ds = ImageFolder(args.dataset, "train", patch, seed=args.seed)
    test_ds = ImageFolder(args.dataset, "test", patch, seed=args.seed)
    state = TrainState(model, device, seed=args.seed + 1,
                       learning_rate=args.learning_rate,
                       aux_learning_rate=args.aux_learning_rate,
                       clip_max_norm=args.clip_max_norm)
    last_epoch, best_loss = 0, float("inf")
    if args.pretrained and os.path.exists(args.pretrained):
        # a CC_GD trainer checkpoint: the whole training state, at epoch 0
        restore_checkpoint(args.pretrained, state)
        print(f"started from {args.pretrained}")
    elif args.checkpoint and os.path.exists(args.checkpoint):
        ckpt = restore_checkpoint(args.checkpoint, state)
        last_epoch = ckpt["epoch"] + 1
        best_loss = ckpt.get("best_loss", ckpt["loss"])
        print(f"resumed from {args.checkpoint} at epoch {last_epoch}")
    step = make_gd_train_step(model, args.lmbda, args.sparse_lambda)
    meta = {"model": args.model, "lmbda": args.lmbda, "metric": "mse"}
    n_subset = max(int(args.subset_scale
                       * (len(train_ds) // args.batch_size)), 1)
    stopped = False

    for epoch in range(last_epoch, args.epochs):
        t0 = time.time()
        it = train_ds.batches(args.batch_size, epoch, args.num_workers)
        for i, batch in enumerate(prefetch_to_device(it, device)):
            metrics = step(state, batch)
            if i % args.log_every == 0:
                print(f"gd epoch {epoch} [{i}]: loss "
                      f"{float(metrics['loss']):.4f} bpp "
                      f"{float(metrics['bpp_loss']):.3f} "
                      f"scale {param_scale(model):.3f}")

        if (epoch + 1) % args.tick_freq == 0:
            print(f"tick at epoch {epoch}")

            def subset(epoch=epoch):
                it = train_ds.batches(args.batch_size, epoch,
                                      args.num_workers)
                try:
                    for _, b in zip(range(n_subset), it):
                        yield torch.from_numpy(b).to(device)
                finally:
                    it.close()

            tick(model, subset, args.lmbda, state.sampler, args.tick_round,
                 args.tick_num, args.learning_rate)
            scale = param_scale(model)
            print(f"post-tick param scale: {scale:.4f}")
            stopped = scale < args.flops_target

        model.eval()
        totals, count = 0.0, 0
        it = test_ds.batches(args.batch_size, 0, args.num_workers)
        with torch.no_grad():
            for batch in prefetch_to_device(it, device):
                out = model(batch, training=False)
                totals += float(rate_distortion_loss(out, batch,
                                                     args.lmbda).loss)
                count += 1
        test_loss = totals / count if count else float("inf")
        print(f"gd test epoch {epoch}: loss {test_loss:.4f} "
              f"[{time.time() - t0:.1f}s]")
        is_best = test_loss < best_loss
        best_loss = min(test_loss, best_loss)
        save_checkpoint(args.save_dir, state, epoch, test_loss, meta,
                        is_best, best_loss)
        if stopped:
            break

    _, deps = prune_export(model, args.save_dir)
    print(f"pruned export: {os.path.join(args.save_dir, PRUNED_MODEL)} "
          f"({sum(deps.values())} kept channels at {len(deps)} gates)")
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
