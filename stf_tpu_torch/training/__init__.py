"""Rate-distortion training (port of `stf_tpu/training`): losses, the
dual-Adam train state and steps, checkpoints and the trainer CLIs
(`python -m stf_tpu_torch.training.train`, `.dytrain` for DYSTF's
distillation, `.train_gd` for CC_GD's gate-decorator pruning)."""

from .dytrain import distill_pruning_loss, make_dytrain_step
from .losses import RDLossOutput, bpp_from_likelihoods, rate_distortion_loss
from .sampler import Sampler
from .state import TrainState, make_eval_step, make_train_step
from .train_gd import (
    accumulate_scores,
    gate_l1_penalty,
    iter_gates,
    load_pruned_checkpoint,
    make_gate_optimizer,
    make_gd_train_step,
    param_scale,
    prune_export,
    prune_masks,
)

__all__ = [
    "RDLossOutput",
    "Sampler",
    "TrainState",
    "accumulate_scores",
    "bpp_from_likelihoods",
    "distill_pruning_loss",
    "gate_l1_penalty",
    "iter_gates",
    "load_pruned_checkpoint",
    "make_dytrain_step",
    "make_eval_step",
    "make_gate_optimizer",
    "make_gd_train_step",
    "make_train_step",
    "param_scale",
    "prune_export",
    "prune_masks",
    "rate_distortion_loss",
]
