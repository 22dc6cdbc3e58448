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

from typing import Callable, Dict, Sequence

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
    no host sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class TrainState:
    """A model with its two optimizers, the main group's schedule, the
    sampler the training forward draws from, and the step count.

    The sampler's generator lives on `device` and is seeded with `seed`.
    Construction sets the numerical policy (`use_numerical_policy`) and
    moves the model to `device`."""

    def __init__(self, model: torch.nn.Module, device, seed: int = 0,
                 learning_rate: float = 1e-4, aux_learning_rate: float = 1e-3,
                 clip_max_norm: float = 1.0, lr_milestones: Sequence[int] = (),
                 lr_gamma: float = 0.1):
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
            torch.Generator(device=self.device).manual_seed(seed)
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


def make_train_step(model: torch.nn.Module, lmbda: float,
                    metric: str = "mse") -> Callable:
    """`train_step(state, batch)`: one training forward of the NHWC batch
    with noise from `state.sampler`, one backward of rd.loss + aux, one
    update. Returns the four metrics as device tensors (reading them
    syncs)."""

    def train_step(state: TrainState, batch: torch.Tensor):
        model.train()
        state.zero_grad()
        out = model(batch, training=True, sampler=state.sampler)
        rd = rate_distortion_loss(out, batch, lmbda, metric)
        aux = model.aux_loss()
        (rd.loss + aux).backward()
        state.apply_gradients()
        return _metrics(rd, aux)

    return train_step


def make_eval_step(model: torch.nn.Module, lmbda: float,
                   metric: str = "mse") -> Callable:
    """`eval_step(batch)`: the rounding forward in eval mode, no gradient;
    the same four metrics."""

    def eval_step(batch: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                out = model(batch, training=False)
                rd = rate_distortion_loss(out, batch, lmbda, metric)
                return _metrics(rd, model.aux_loss())
        finally:
            model.train(was_training)

    return eval_step
