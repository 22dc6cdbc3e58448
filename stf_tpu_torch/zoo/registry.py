"""Model registry (port of `stf_tpu/zoo/registry.py`): the reference CLI's
six names, cnn, stf, tbc, dystf, cc and cc_gd."""

from typing import Optional

import torch

from ..models import (
    CC,
    CC_GD,
    DYSTF,
    WACNN,
    SymmetricalTransFormer,
    TransformerBasedCoding,
    init_weights,
)


class _Models(dict):
    def __missing__(self, key):
        raise KeyError(
            f"unknown model {key!r} (available: {', '.join(sorted(self))})"
        )


models = _Models(
    cnn=WACNN,
    stf=SymmetricalTransFormer,
    tbc=TransformerBasedCoding,
    dystf=DYSTF,
    cc=CC,
    cc_gd=CC_GD,
)


def create_model(name: str, seed: Optional[int] = None, **kwargs):
    """Build a registry model; with `seed`, its weights are drawn from a
    `torch.Generator` seeded with it (reproducible random weights)."""
    model = models[name](**kwargs)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model
