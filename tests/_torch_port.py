"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py):
a small JAX WACNN and the port's WACNN at the same weights."""

import jax
import jax.numpy as jnp
import numpy as np

from stf_tpu.models import WACNN as JaxWACNN
from stf_tpu_torch.models import WACNN
from stf_tpu_torch.zoo import state_dict_from_jax

# the size tests/test_lane_codec.py uses
SMALL = dict(N=32, M=40, num_slices=4, max_support_slices=2)


def jax_small(seed: int = 0):
    """(flax model, params as a nested dict of NumPy arrays)."""
    model = JaxWACNN(**SMALL)
    variables = model.init(
        {"params": jax.random.key(seed), "noise": jax.random.key(seed + 1)},
        jnp.zeros((1, 64, 64, 3), jnp.float32),
        training=False,
    )
    return model, jax.tree_util.tree_map(np.asarray, variables["params"])


def port_small(params):
    """The port's WACNN loaded (strict) from flax params."""
    model = WACNN(**SMALL)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


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
