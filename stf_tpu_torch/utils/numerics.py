"""The port's one numerical policy for f32 work on the card."""

import torch


def use_f32_policy() -> None:
    """Full f32 products and convolutions (no TF32) and deterministic cuDNN
    algorithms, picked without benchmarking. The codec needs it so that
    encoder and decoder agree bitwise; the trainer sets the same, so that
    neither inherits the other's flags from whichever ran first."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
