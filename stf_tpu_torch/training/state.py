"""Train state: the dual main/aux Adam and the train and eval steps (port
of `stf_tpu/training/state.py`).

As in the reference (`train.py:88-119,131-150`) two Adams train the model:
"main" (lr 1e-4, global-norm clip 1.0) over every parameter but the
bottleneck's `quantiles`, and "aux" (lr 1e-3, no clip) over the
quantiles. One backward of `rd.loss + aux` feeds both, as the JAX
package's combined loss does: the detached medians keep the RD gradient
off the quantiles, and the aux loss's detached logits keep its gradient
on them alone.

The clip is optax's `clip_by_global_norm`: the norm over the main group
only, and g -> g / ||g|| * max where ||g|| >= max (torch's
`clip_grad_norm_` divides by ||g|| + 1e-6 instead). torch's Adam and
optax's `adam` take the same bias-corrected step with eps 1e-8 outside
the square root. The learning rate is piecewise constant by step, scaled
by `lr_gamma` at each boundary (`MultiStepLR` stepped once a step, as
optax's schedule reads its update count).
"""

from typing import Callable, Dict, Sequence, Tuple

import torch

from ..utils.numerics import use_numerical_policy
from .losses import rate_distortion_loss
from .sampler import Sampler


def is_aux_parameter(name: str) -> bool:
    """The aux group is the bottleneck's `quantiles`."""
    return "quantiles" in name.split(".")


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """optax's clip, in place: every g becomes g / ||g|| * max_norm unless
    the global norm ||g|| is under max_norm. Returns the norm (a tensor:
    no host sync). Sharded gradients (a `fully_shard`ed model's DTensors)
    are clipped through their local shards, the norm's partial sums
    reduced over the mesh dims they are sharded on: one all-reduce, where
    DTensor arithmetic would run a collective and its dispatch for every
    tensor."""
    if not any(_is_dtensor(g) for g in grads):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        local = grads
    else:
        norm = torch.sqrt(_sharded_sum_of_squares(grads))
        local = [g.to_local() if _is_dtensor(g) else g for g in grads]
    keep = norm < max_norm
    for g in local:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _sharded_sum_of_squares(grads):
    """sum(g * g) over every gradient, sharded or not: each DTensor's
    local shard summed, the sums all-reduced over the mesh dims where
    the shards lie (for a `fully_shard`ed model every parameter has the
    same mesh and placements), plus the plain gradients' sums."""
    import torch.distributed as dist

    plain, by_layout = [], {}
    for g in grads:
        if _is_dtensor(g):
            key = (g.device_mesh, tuple(g.placements))
            by_layout.setdefault(key, []).append(g.to_local())
        else:
            plain.append(g)
    total = sum(torch.sum(g * g) for g in plain)
    for (mesh, placements), shards in by_layout.items():
        part = torch.stack([torch.sum(t * t) for t in shards]).sum()
        for dim, p in enumerate(placements):
            if p.is_shard():
                dist.all_reduce(part, group=mesh.get_group(dim))
        total = total + part
    return total


class TrainState:
    """A model with its two optimizers, the main group's schedule, the
    sampler the training forward draws from, and the step count.

    The sampler's generator lives on `device` and is seeded with `seed`;
    `shard` = (index, count) is this rank's share of the global batch
    (`Sampler`): every rank draws the global batch's values and keeps its
    rows. Construction sets the numerical policy (`use_numerical_policy`) and
    moves the model to `device`."""

    def __init__(self, model: torch.nn.Module, device, seed: int = 0,
                 learning_rate: float = 1e-4, aux_learning_rate: float = 1e-3,
                 clip_max_norm: float = 1.0, lr_milestones: Sequence[int] = (),
                 lr_gamma: float = 0.1, shard: Tuple[int, int] = (0, 1)):
        use_numerical_policy()
        self.device = torch.device(device)
        self.model = model.to(self.device)
        named = list(model.named_parameters())
        self.main_params = [p for n, p in named if not is_aux_parameter(n)]
        self.aux_params = [p for n, p in named if is_aux_parameter(n)]
        self.clip_max_norm = clip_max_norm
        self.optimizer = torch.optim.Adam(self.main_params, lr=learning_rate)
        self.aux_optimizer = torch.optim.Adam(self.aux_params,
                                              lr=aux_learning_rate)
        self.lr_scheduler = torch.optim.lr_scheduler.MultiStepLR(
            self.optimizer, milestones=list(lr_milestones), gamma=lr_gamma
        )
        self.sampler = Sampler(
            torch.Generator(device=self.device).manual_seed(seed), shard
        )
        self.step = 0

    @property
    def learning_rate(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)
        self.aux_optimizer.zero_grad(set_to_none=True)

    def apply_gradients(self):
        """One update from the parameters' .grad: clip the main group, step
        both Adams and the schedule."""
        if self.clip_max_norm and self.clip_max_norm > 0:
            grads = [p.grad for p in self.main_params if p.grad is not None]
            clip_by_global_norm(grads, self.clip_max_norm)
        self.optimizer.step()
        self.aux_optimizer.step()
        self.lr_scheduler.step()
        self.step += 1

    def state_dict(self) -> Dict:
        """Everything a resume restores (tensors stay where they are)."""
        return {
            "state_dict": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "aux_optimizer": self.aux_optimizer.state_dict(),
            "lr_scheduler": self.lr_scheduler.state_dict(),
            "generator": self.sampler.generator.get_state(),
            "step": self.step,
        }

    def load_state_dict(self, d: Dict):
        self.model.load_state_dict(d["state_dict"])
        self.optimizer.load_state_dict(d["optimizer"])
        self.aux_optimizer.load_state_dict(d["aux_optimizer"])
        self.lr_scheduler.load_state_dict(d["lr_scheduler"])
        self.sampler.generator.set_state(d["generator"])
        self.step = int(d["step"])


def _metrics(rd, aux) -> Dict[str, torch.Tensor]:
    return {"loss": rd.loss.detach(), "bpp_loss": rd.bpp_loss.detach(),
            "distortion": rd.distortion.detach(), "aux_loss": aux.detach()}


class TrainForward(torch.nn.Module):
    """The model's forward and its aux loss in one call: (out, aux). A
    parallel wrapper (DDP, `fully_shard`) sees only what runs inside
    `forward`, and the quantiles take their gradient from the aux loss
    alone."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, training: bool = True, sampler=None):
        if training:
            out = self.model(batch, training=True, sampler=sampler)
        else:
            out = self.model(batch, training=False)
        return out, self.model.aux_loss()


def as_train_forward(module: torch.nn.Module) -> torch.nn.Module:
    """`module` if it already is a training forward (a `TrainForward`, or
    `parallel.parallelize`'s DDP or `fully_shard` wrapper of one), else
    `TrainForward(module)`."""
    from torch.nn.parallel import DistributedDataParallel

    inner = (module.module if isinstance(module, DistributedDataParallel)
             else module)
    return module if isinstance(inner, TrainForward) else TrainForward(module)


def make_train_step(model: torch.nn.Module, lmbda: float,
                    metric: str = "mse") -> Callable:
    """`train_step(state, batch)`: one training forward of the NHWC batch
    with noise from `state.sampler`, one backward of rd.loss + aux, one
    update. Returns the four metrics as device tensors (reading them
    syncs). `model` is the model or its training forward
    (`as_train_forward`), e.g. `parallel.parallelize`'s wrapper."""
    forward = as_train_forward(model)

    def train_step(state: TrainState, batch: torch.Tensor):
        forward.train()
        state.zero_grad()
        out, aux = forward(batch, sampler=state.sampler)
        rd = rate_distortion_loss(out, batch, lmbda, metric)
        (rd.loss + aux).backward()
        state.apply_gradients()
        return _metrics(rd, aux)

    return train_step


def make_eval_step(model: torch.nn.Module, lmbda: float,
                   metric: str = "mse") -> Callable:
    """`eval_step(batch)`: the rounding forward in eval mode, no gradient;
    the same four metrics. `model` as in `make_train_step`."""
    forward = as_train_forward(model)

    def eval_step(batch: torch.Tensor):
        was_training = forward.training
        forward.eval()
        try:
            with torch.no_grad():
                out, aux = forward(batch, training=False)
                return _metrics(rate_distortion_loss(out, batch, lmbda,
                                                     metric), aux)
        finally:
            forward.train(was_training)

    return eval_step
