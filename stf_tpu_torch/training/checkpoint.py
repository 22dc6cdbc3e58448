"""Training checkpoints with `torch.save`, in the reference's layout.

A checkpoint is one dict (`SURVEY.md` section 5): {epoch, state_dict,
loss, optimizer, aux_optimizer, lr_scheduler}, plus the step, the best
loss so far, the sampler's generator state, and the JAX trainer's
sidecar meta (model, lmbda, metric). `save_checkpoint` writes
`checkpoint.pth.tar` and, for a new best, copies it to
`checkpoint_best.pth.tar`. The state_dict carries the reference torch
names, so a fresh registry model loads it strictly and
`stf_tpu.zoo.torch_import.import_state_dict` maps it to flax params.
"""

import os
import shutil
from typing import Dict

import torch

CHECKPOINT = "checkpoint.pth.tar"
CHECKPOINT_BEST = "checkpoint_best.pth.tar"


def save_checkpoint(save_dir: str, state, epoch: int, loss: float,
                    meta: Dict, is_best: bool, best_loss: float) -> str:
    """Write `state` (a TrainState) with the epoch, its test loss, the best
    loss and `meta` ({"model", "lmbda", "metric"}); returns the path."""
    os.makedirs(save_dir, exist_ok=True)
    blob = dict(state.state_dict(), epoch=epoch, loss=float(loss),
                best_loss=float(best_loss), **meta)
    path = os.path.join(save_dir, CHECKPOINT)
    torch.save(blob, path)
    if is_best:
        shutil.copyfile(path, os.path.join(save_dir, CHECKPOINT_BEST))
    return path


def load_checkpoint(path: str) -> Dict:
    """The checkpoint dict, tensors on the CPU. Only files this trainer
    wrote: the scheduler's state is unpickled."""
    return torch.load(path, map_location="cpu", weights_only=False)


def restore_checkpoint(path: str, state) -> Dict:
    """Load model, optimizers, schedule, generator and step into `state`;
    returns the checkpoint dict (epoch, best_loss and the meta)."""
    ckpt = load_checkpoint(path)
    state.load_state_dict(ckpt)
    return ckpt
