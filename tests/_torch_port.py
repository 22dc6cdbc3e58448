"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py):
a small JAX WACNN and the port's WACNN at the same weights."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

from stf_tpu.models import WACNN as JaxWACNN
from stf_tpu.zoo.torch_import import import_state_dict
from stf_tpu_torch.models import WACNN, init_weights

# the size tests/test_lane_codec.py uses
SMALL = dict(N=32, M=40, num_slices=4, max_support_slices=2)


def pair_from_port(seed: int = 0):
    """(flax model, params, port model): the port's WACNN with weights
    drawn by `init_weights` from a seeded generator, and the same weights
    as flax params. The flax template comes from `jax.eval_shape`, which
    skips the ~70 s CPU cost of running flax's init.

    `init_weights` draws convs and linears at torch's default scale, where
    y barely depends on the image (x_hat is the same for every image and
    every y likelihood ~1), so a comparison would miss a fault in g_a or
    the hyper path. They are scaled to He-normal size (std
    sqrt(2/fan_in), flax's conv init), and the synthesis's to half that,
    which keeps x_hat within a few units, as the fixture built from
    flax's init did."""
    port = init_weights(WACNN(**SMALL), torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, m in port.named_modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                m.weight.mul_(math.sqrt(6) / (2 if name.startswith("g_s") else 1))
    model = JaxWACNN(**SMALL)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32), training=False,
    ))["params"]
    template = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes
    )
    params = import_state_dict("cnn", template, {
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
