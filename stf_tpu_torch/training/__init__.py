"""Rate-distortion training (port of `stf_tpu/training`): losses, the
dual-Adam train state and steps, checkpoints and the trainer CLI
(`python -m stf_tpu_torch.training.train`)."""

from .losses import RDLossOutput, bpp_from_likelihoods, rate_distortion_loss
from .sampler import Sampler
from .state import TrainState, make_eval_step, make_train_step

__all__ = [
    "RDLossOutput",
    "Sampler",
    "TrainState",
    "bpp_from_likelihoods",
    "make_eval_step",
    "make_train_step",
    "rate_distortion_loss",
]
