"""The port's one numerical policy for its work on the card."""

import torch


def use_numerical_policy() -> None:
    """Full f32 products and convolutions (no TF32), bf16 products summed
    in f32 as XLA sums them (no reduced-precision reductions), and
    deterministic cuDNN algorithms, picked without benchmarking. The codec
    needs it so that encoder and decoder agree bitwise, in f32 and in
    bf16 alike (its `dtype` decides which parts run in bf16, not this
    policy); the trainer sets the same, so that neither inherits the
    other's flags from whichever ran first."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
