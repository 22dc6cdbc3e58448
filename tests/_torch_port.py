"""Shared set-up for the PyTorch-port parity tests (tests/test_torch_*.py):
a small JAX model and the port's at the same weights, for each of the six
registry names."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stf_tpu.models import WACNN as JaxWACNN
from stf_tpu.models import SymmetricalTransFormer as JaxSTF
from stf_tpu.models.cc import CC as JaxCC
from stf_tpu.models.cc_gd import CC_GD as JaxCC_GD
from stf_tpu.models.dystf import DYSTF as JaxDYSTF
from stf_tpu.models.tbc import TransformerBasedCoding as JaxTBC
from stf_tpu.zoo.torch_import import import_state_dict
from stf_tpu_torch.models import (
    CC,
    CC_GD,
    DYSTF,
    WACNN,
    SymmetricalTransFormer,
    TransformerBasedCoding,
    init_weights,
)

from _torch_configs import (  # noqa: F401 (re-exported)
    CONFIGS,
    DYSTF_SMALL,
    DYSTF_TRAIN,
    SMALL,
    STF_SMALL,
    TBC_SMALL,
)
from _torch_scale import he_scale
from _torch_threads import one_torch_thread  # noqa: F401 (re-exported)

_MODELS = {"cnn": (WACNN, JaxWACNN), "stf": (SymmetricalTransFormer, JaxSTF),
           "tbc": (TransformerBasedCoding, JaxTBC), "cc": (CC, JaxCC),
           "cc_gd": (CC_GD, JaxCC_GD), "dystf": (DYSTF, JaxDYSTF)}


def jax_template(model, size: int = 64):
    """Zeros of the flax params of `model`, shaped by `jax.eval_shape` of
    its init at a size x size input (flax's init itself costs tens of
    CPU-seconds at these sizes)."""
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        jnp.zeros((1, size, size, 3), jnp.float32), training=False,
    ))["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def to_jax(name: str, port, model=None, **kwargs):
    """(flax model, params) holding the port model's weights: `model` (the
    JAX `name` class at CONFIGS[name] and `kwargs` by default) and its
    template filled through the JAX package's `import_state_dict`."""
    if model is None:
        model = _MODELS[name][1](**{**CONFIGS[name], **kwargs})
    params = import_state_dict(name, jax_template(model), {
        k: v.detach().numpy() for k, v in port.state_dict().items()
    })
    return model, params


def port_small(seed: int = 0, name: str = "cnn"):
    """The port's small `name` model with weights drawn by `init_weights`
    from a seeded generator and scaled by `_torch_scale.he_scale`
    (He-normal size, the synthesis at half, LayerNorms moved off 1 and 0),
    in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    port = init_weights(_MODELS[name][0](**CONFIGS[name]), gen)
    return he_scale(port, gen, name).eval()


def pair_from_port(seed: int = 0, name: str = "cnn"):
    """(flax model, params, port model): `port_small(seed, name)` and the
    same weights as flax params (`to_jax`). The flax template comes from
    `jax.eval_shape`, which skips the ~70 s CPU cost of running flax's
    init."""
    port = port_small(seed, name)
    return (*to_jax(name, port), port)


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
