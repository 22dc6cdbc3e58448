"""Shared set-up for the tests of the port's user entry points
(tests/test_torch_eval_*.py, tests/test_torch_rd_compare.py): an image
folder, the port's small checkpoints, and JAX registry entries for the
same small models."""

import jax
import jax.numpy as jnp
import torch

from stf_tpu.models import WACNN as JaxWACNN
from stf_tpu.models import SymmetricalTransFormer as JaxSTF
from stf_tpu_torch.models import init_weights
from stf_tpu_torch.zoo import models

from _torch_port import SMALL, STF_SMALL, smooth_images
from _torch_scale import he_scale

CONFIGS = {"cnn": SMALL, "stf": STF_SMALL}
# the host coder's metrics against the JAX CLI's (bpp is compared for
# equality): the same integers, x_hat from f32 transforms within 1e-4
HOST_TOL = {"psnr": 1e-4, "ms-ssim": 1e-5}


def write_images(root) -> str:
    """Three PNGs under `root`: two 64x64 (one x64 bucket) and a 70x90
    one that pads to 128x128, smooth images with noise from fixed seeds.
    Returns the folder as a string."""
    from PIL import Image

    for name, (h, w), seed in (("a.png", (64, 64), 1), ("b.png", (64, 64), 2),
                               ("c.png", (70, 90), 3)):
        Image.fromarray(smooth_images(1, h, w, seed)[0]).save(root / name)
    return str(root)


def port_model(seed: int, name: str = "cnn"):
    """The port's small `name` model at `_torch_port.pair_from_port`'s
    weights for `seed`, without the flax params."""
    gen = torch.Generator().manual_seed(seed)
    model = init_weights(models[name](**CONFIGS[name]), gen)
    return he_scale(model, gen, name).eval()


def save_port_checkpoint(path, port, name: str) -> str:
    """The port's eval checkpoint of `port`, the small `name` model."""
    from stf_tpu_torch.zoo import save_checkpoint

    save_checkpoint(str(path), name, port, CONFIGS[name])
    return str(path)


def jax_small_entry(name: str):
    """A JAX registry entry for the small `name` model whose flax `init`
    returns zeros of its parameters' shapes through `jax.eval_shape`.
    The JAX checkpoint loaders read only the shapes of the init they run
    and then fill every leaf from the file; running flax's init at their
    256x256 input costs ~40 CPU-seconds a load."""
    base = {"cnn": JaxWACNN, "stf": JaxSTF}[name]

    class Small(base):
        def init(self, rngs, *args, **kwargs):
            shapes = jax.eval_shape(
                lambda: super(Small, self).init(rngs, *args, **kwargs)
            )
            return jax.tree_util.tree_map(
                lambda s: jnp.zeros(s.shape, s.dtype), shapes
            )

    return lambda **kw: Small(**{**CONFIGS[name], **kw})


def close(got: dict, want: dict, exact=(), tol=None):
    """Hold the port's metrics against JAX's: the same keys (times apart
    from their values), `exact` keys equal, each key of `tol` within its
    absolute tolerance. Prints every difference."""
    assert got.keys() == want.keys()
    for k in sorted(want):
        if "time" not in k:
            print(f"{k}: port {got[k]!r} JAX {want[k]!r} "
                  f"(diff {got[k] - want[k]:.3g})")
    for k in exact:
        assert got[k] == want[k], k
    for k, t in (tol or {}).items():
        assert abs(got[k] - want[k]) <= t, k
    for k in got:
        if "time" in k:
            assert got[k] >= 0
