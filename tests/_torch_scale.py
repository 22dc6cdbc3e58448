"""He-normal weights for the port's model tests. Imports no JAX, so the
card tests (`tests/test_torch_cuda.py`) use it as the CPU tests do."""

import math

import torch
from torch import nn

# the synthesis transform of each model, scaled to half the others
SYNTHESIS = {"cnn": ("g_s",), "stf": ("syn_layers", "end_conv"),
             "tbc": ("syn_layers",), "cc": ("g_s",), "cc_gd": ("g_s",),
             "dystf": ("syn_layers", "end_conv")}


def he_scale(port, gen, name: str):
    """Scale the convs and linears of the port's `name` model (a registry
    name), drawn by `init_weights`, in place to He-normal size (std
    sqrt(2/fan_in), flax's conv init), and the synthesis's to half that;
    draw LayerNorm weights and biases from 1 + U(-0.5, 0.5) and
    U(-0.5, 0.5) with `gen`. Returns the model.

    At `init_weights`' own scale y barely depends on the image (x_hat is
    the same for every image and every y likelihood ~1), so a comparison
    would miss a fault in g_a or the hyper path; the half-size synthesis
    keeps x_hat within a few units, and the drawn norms make a norm left
    out or swapped for another change the output."""
    synthesis = SYNTHESIS[name]
    with torch.no_grad():
        for key, m in port.named_modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                m.weight.mul_(math.sqrt(6) / (2 if key.startswith(synthesis)
                                              else 1))
            elif isinstance(m, nn.LayerNorm):
                m.weight.add_(torch.rand(m.weight.shape, generator=gen) - 0.5)
                m.bias.add_(torch.rand(m.bias.shape, generator=gen) - 0.5)
    return port


def random_gates(port, seed: int):
    """CC_GD's gates drawn from U(0.5, 1.5) and its masks from
    Bernoulli(2/3) with a generator seeded `seed`, in place (at their init
    of ones a gate or mask read from the wrong index would go unseen).
    Returns the model."""
    from stf_tpu_torch.models.cc_gd import GateDecorator

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, GateDecorator):
                m.gate.copy_(torch.rand(m.gate.shape, generator=gen) + 0.5)
                m.mask.copy_((torch.rand(m.mask.shape, generator=gen)
                              < 2 / 3).float())
    return port
