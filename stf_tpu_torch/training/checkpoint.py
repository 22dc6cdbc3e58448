"""Training checkpoints with `torch.save`, in the reference's layout.

A checkpoint is one dict (`SURVEY.md` section 5): {epoch, state_dict,
loss, optimizer, aux_optimizer, lr_scheduler}, plus the step, the best
loss so far, the sampler's generator state, and the JAX trainer's
sidecar meta (model, lmbda, metric). `save_checkpoint` writes
`checkpoint.pth.tar` and, for a new best, copies it to
`checkpoint_best.pth.tar`. The state_dict carries the reference torch
names, so a fresh registry model loads it strictly and
`stf_tpu.zoo.torch_import.import_state_dict` maps it to flax params.

The sharded format (`ShardedCheckpointer`, the counterpart of the JAX
package's `OrbaxCheckpointer`, `stf_tpu/training/checkpoint.py:77-224`)
is a collective save through `torch.distributed.checkpoint`: every rank
writes only the shards it holds (a `fully_shard`ed model is never
gathered for it), asynchronously (training goes on while it writes).
Layout under the save directory:

    latest/<epoch>/      rolling latest (keeps 2)
    best/<epoch>/        best by test loss (keeps 1)
    params.pth.tar       params-only sidecar (the zoo's format), latest
    params_best.pth.tar  the same, best test loss

A step directory is complete once its `.metadata` is written (the last
file of a save). Resume by passing the save directory itself.
"""

import os
import shutil
from typing import Dict, Optional

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


def _train_state(state, meta: Optional[Dict] = None) -> Dict:
    """What a sharded save holds: the model's and both optimizers' state
    dicts as `torch.distributed.checkpoint` addresses them (sharded
    entries stay sharded), the generator, and the schedule, step and
    meta as one pickled item (a tuple is saved whole; the schedule's
    dict, saved key by key, would not load into another's)."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model, optim = get_state_dict(
        state.model, [state.optimizer, state.aux_optimizer])
    return {"model": model, "optim": optim,
            "generator": state.sampler.generator.get_state(),
            "extra": (state.lr_scheduler.state_dict(), state.step, meta)}


class ShardedCheckpointer:
    """Collective, asynchronous train-state checkpoints in `save_dir`.

    Every rank calls `save` and `restore` with the same arguments (the
    trainer reduces the test loss over the ranks before its `is_best`).
    The latest and best saves of one epoch run at once; each namespace
    runs its collectives on a gloo group of its own, so neither meets
    the other's nor the training's (the fault JAX's barrier prefixes
    fix, `stf_tpu/training/checkpoint.py:100-108`). A namespace's next
    save waits for its previous one; `close()` drains both. The JAX
    package gathers the parameters for its sidecars at each save; here
    rank 0 reads them back from the landed save's files with no
    collective (a shared file system, which the collective save assumes
    too). That read-back (`_write_sidecar`) runs when the namespace's
    next save starts, or in `close()`: until then a sidecar holds the
    namespace's previous save, one epoch behind its newest step
    directory, and while rank 0 reads, the other ranks wait for it in
    that next save's first collective.
    `read_only=True` opens a foreign run's directory for `restore` only:
    nothing is created or removed there."""

    LATEST, BEST = "latest", "best"
    KEEP = {LATEST: 2, BEST: 1}
    SIDECAR = {LATEST: "params.pth.tar", BEST: "params_best.pth.tar"}

    def __init__(self, save_dir: str, read_only: bool = False):
        from ..parallel import process_count

        self.root = os.path.abspath(save_dir)
        self.read_only = bool(read_only)
        self._pending = {}
        self._groups = {ns: None for ns in self.KEEP}
        if not self.read_only:
            os.makedirs(self.root, exist_ok=True)
            if process_count() > 1:
                import torch.distributed as dist

                self._groups = {ns: dist.new_group(backend="gloo")
                                for ns in self.KEEP}

    def _epochs(self, ns: str):
        """The complete step directories of a namespace, oldest first."""
        d = os.path.join(self.root, ns)
        if not os.path.isdir(d):
            return []
        return sorted(int(e) for e in os.listdir(d) if e.isdigit()
                      and os.path.exists(os.path.join(d, e, ".metadata")))

    def _wait(self, ns: str):
        """Let the namespace's pending save land; then rank 0 writes its
        params-only sidecar from the files just written (no collective:
        a sharded model is never gathered for it) and keeps the newest
        KEEP[ns] steps."""
        from ..parallel import is_main_process

        fut, epoch, model_name = self._pending.pop(ns, (None, None, None))
        if fut is None:
            return
        fut.result()
        if is_main_process():
            if model_name:
                self._write_sidecar(ns, epoch, model_name)
            for e in self._epochs(ns)[:-self.KEEP[ns]]:
                shutil.rmtree(os.path.join(self.root, ns, str(e)))

    def _write_sidecar(self, ns: str, epoch: int, model_name: str):
        """The namespace's params sidecar, from the files of its landed
        save at `epoch` (rank 0)."""
        from ..zoo.checkpoint import save_state_dict

        save_state_dict(os.path.join(self.root, self.SIDECAR[ns]),
                        model_name, read_model_state(
                            os.path.join(self.root, ns, str(epoch))))

    def save(self, state, epoch: int, loss: float, meta: Dict,
             is_best: bool, best_loss: float) -> None:
        """Start the collective save of `state` (a TrainState) in
        latest/<epoch> (and best/<epoch>), with the meta (epoch, loss,
        best_loss and `meta`'s model, lmbda, metric). When a save has
        landed (the namespace's next save, or `close`), rank 0 writes its
        sidecar, params.pth.tar (params_best.pth.tar for best)."""
        import torch.distributed.checkpoint as dcp

        if self.read_only:
            raise RuntimeError(f"ShardedCheckpointer({self.root!r}) was "
                               "opened read_only")
        meta = dict(meta, epoch=int(epoch), loss=float(loss),
                    best_loss=float(best_loss))
        blob = _train_state(state, meta)
        for ns in (self.LATEST, self.BEST) if is_best else (self.LATEST,):
            self._wait(ns)
            fut = dcp.async_save(
                blob, checkpoint_id=os.path.join(self.root, ns, str(epoch)),
                process_group=self._groups[ns])
            self._pending[ns] = (fut, int(epoch), meta.get("model"))

    def restore(self, state) -> Dict:
        """Load the newest complete latest/<epoch> into `state` on its own
        placement (each rank reads the shards it holds); returns the
        meta."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.state_dict import set_state_dict

        epochs = self._epochs(self.LATEST)
        if not epochs:
            raise FileNotFoundError(f"no sharded checkpoint under "
                                    f"{self.root}/{self.LATEST}")
        blob = _train_state(state)
        dcp.load(blob, checkpoint_id=os.path.join(self.root, self.LATEST,
                                                  str(epochs[-1])))
        set_state_dict(state.model, [state.optimizer, state.aux_optimizer],
                       model_state_dict=blob["model"],
                       optim_state_dict=blob["optim"])
        schedule, step, meta = blob["extra"]
        state.lr_scheduler.load_state_dict(schedule)
        state.sampler.generator.set_state(blob["generator"])
        state.step = int(step)
        return meta

    def close(self) -> None:
        for ns in list(self._pending):
            self._wait(ns)


def read_model_state(path: str) -> Dict:
    """The full model state_dict (CPU tensors) of the complete sharded
    checkpoint at `path` (a step directory), read by this process alone:
    every rank's shards, at the sizes its metadata records."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = dcp.FileSystemReader(path).read_metadata()
    state = {k: torch.empty(m.size, dtype=m.properties.dtype)
             for k, m in meta.state_dict_metadata.items()
             if k.startswith("model.") and isinstance(m, TensorStorageMetadata)}
    dcp.load(state, checkpoint_id=path, no_dist=True)
    return {k[len("model."):]: v for k, v in state.items()}


def is_sharded_checkpoint(path: str) -> bool:
    """True if `path` is a save directory with sharded checkpoints (the
    trainer's `--checkpoint` resume dispatch)."""
    return os.path.isdir(os.path.join(path, ShardedCheckpointer.LATEST))
