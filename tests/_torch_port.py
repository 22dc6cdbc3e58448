"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py):
a small JAX model and the port's at the same weights (WACNN or STF)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stf_tpu.models import WACNN as JaxWACNN
from stf_tpu.models import SymmetricalTransFormer as JaxSTF
from stf_tpu.zoo.torch_import import import_state_dict
from stf_tpu_torch.models import WACNN, SymmetricalTransFormer, init_weights

from _torch_scale import he_scale

# the size tests/test_lane_codec.py uses
SMALL = dict(N=32, M=40, num_slices=4, max_support_slices=2)
# a small STF at the full model's head width 16 (B1's stf geometry):
# stages of 16, 32, 64 and 128 channels, y of 128 in 4 slices of 32
STF_SMALL = dict(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                 num_slices=4)
_MODELS = {"cnn": (WACNN, JaxWACNN, SMALL),
           "stf": (SymmetricalTransFormer, JaxSTF, STF_SMALL)}


def pair_from_port(seed: int = 0, name: str = "cnn"):
    """(flax model, params, port model): the port's small `name` model
    ("cnn" or "stf") with weights drawn by `init_weights` from a seeded
    generator and scaled by `_torch_scale.he_scale` (He-normal size, the
    synthesis at half, LayerNorms moved off 1 and 0), and the same
    weights as flax params. The flax template comes from
    `jax.eval_shape`, which skips the ~70 s CPU cost of running flax's
    init."""
    port_cls, jax_cls, cfg = _MODELS[name]
    gen = torch.Generator().manual_seed(seed)
    port = he_scale(init_weights(port_cls(**cfg), gen), gen, name)
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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for a module that imports this fixture: under
    the suite's parallel workers torch's default of a thread a core
    oversubscribes the machine, and its small ops then wait on each
    other's spinning threads (a train step ran ~45x slower than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
