"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py):
a small JAX model and the port's at the same weights (WACNN or STF)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from stf_tpu.models import WACNN as JaxWACNN
from stf_tpu.models import SymmetricalTransFormer as JaxSTF
from stf_tpu.zoo.torch_import import import_state_dict
from stf_tpu_torch.models import WACNN, SymmetricalTransFormer, init_weights

# the size tests/test_lane_codec.py uses
SMALL = dict(N=32, M=40, num_slices=4, max_support_slices=2)
# a small STF at the full model's head width 16 (B1's stf geometry):
# stages of 16, 32, 64 and 128 channels, y of 128 in 4 slices of 32
STF_SMALL = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                 num_slices=4)
_MODELS = {"cnn": (WACNN, JaxWACNN, SMALL, ("g_s",)),
           "stf": (SymmetricalTransFormer, JaxSTF, STF_SMALL,
                   ("syn_layers", "end_conv"))}


def pair_from_port(seed: int = 0, name: str = "cnn"):
    """(flax model, params, port model): the port's small `name` model
    ("cnn" or "stf") with weights drawn by `init_weights` from a seeded
    generator, and the same weights as flax params. The flax template
    comes from `jax.eval_shape`, which skips the ~70 s CPU cost of running
    flax's init.

    `init_weights` draws convs and linears at torch's default scale, where
    y barely depends on the image (x_hat is the same for every image and
    every y likelihood ~1), so a comparison would miss a fault in g_a or
    the hyper path. They are scaled to He-normal size (std
    sqrt(2/fan_in), flax's conv init), and the synthesis's to half that,
    which keeps x_hat within a few units, as the fixture built from
    flax's init did. LayerNorm weights and biases are drawn from
    1 + U(-0.5, 0.5) and U(-0.5, 0.5), so a norm left out or swapped for
    another changes the output."""
    port_cls, jax_cls, cfg, synthesis = _MODELS[name]
    gen = torch.Generator().manual_seed(seed)
    port = init_weights(port_cls(**cfg), gen)
    with torch.no_grad():
        for key, m in port.named_modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                m.weight.mul_(math.sqrt(6) / (2 if key.startswith(synthesis)
                                              else 1))
            elif isinstance(m, nn.LayerNorm):
                m.weight.add_(torch.rand(m.weight.shape, generator=gen) - 0.5)
                m.bias.add_(torch.rand(m.bias.shape, generator=gen) - 0.5)
    model = jax_cls(**cfg)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), training=False,
    ))["params"]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes
    )
    params = import_state_dict(name, template, {
        k: v.detach().numpy() for k, v in port.state_dict().items()
    })
    return model, params, port.eval()


def flat_leaves(tree, prefix=()):
    """{path tuple: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def smooth_images(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """uint8 (n, h, w, 3) smooth gradients with mild noise."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = []
    for _ in range(n):
        base = 0.5 + r.uniform(0.1, 0.35) * np.sin(
            xx * 2 * np.pi * r.uniform(0.5, 3) / w + r.uniform(0, 7)
        ) * np.cos(yy * 2 * np.pi * r.uniform(0.5, 3) / h + r.uniform(0, 7))
        img = np.stack([base, base[::-1], base[:, ::-1]], -1)
        img = img + r.normal(0, 0.03, img.shape)
        imgs.append(np.clip(img, 0, 1))
    return (np.stack(imgs) * 255).round().astype(np.uint8)


def jax_walk_indexes(jcodec, x):
    """The JAX codec's per-slice (symbols, indexes), from the same jitted
    programs its compress() runs."""
    model = jcodec.model
    y, z = jcodec._analyze(jcodec.params, jnp.asarray(x))
    *_, z_hat = jcodec._z_quantize(z, jnp.asarray(jcodec.eb_coder.medians))
    lm, ls = jcodec._hyper(jcodec.params, z_hat, (y.shape[1], y.shape[2]))
    y_slices = jnp.split(y, model.slice_boundaries(y.shape[-1]), axis=-1)
    out = []

    def get_symbols(i, mu, idx):
        q = jnp.round(y_slices[i] - mu).astype(jnp.int32)
        out.append((np.asarray(q), np.asarray(idx)))
        return q

    jcodec._walk_slices(lm, ls, get_symbols)
    return out
