"""The port's image metrics and data loader against the JAX package's, on
the CPU: SSIM and MS-SSIM (values and gradients) at 64 and 256 pixels,
the 1e-4 floor included, and `ImageFolder`'s batches for one seed.
Tolerance: rel 1e-5 on values, 1e-4 of the largest JAX gradient on
gradients (f32 blurs summed in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu.datasets import ImageFolder as JaxImageFolder
from stf_tpu.utils import metrics as jm
from stf_tpu_torch.datasets import ImageFolder, prefetch_to_device
from stf_tpu_torch.utils import metrics as pm


def _pair(size, kind, seed=0):
    """Two NHWC f32 batches: "related" (x and a noisy copy) or
    "anticorrelated" (1 - x with noise), where the coarse scales' contrast
    terms go negative and the floor decides."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    base = 0.5 + 0.3 * np.sin(xx * 9 + 1) * np.cos(yy * 7)
    x = np.stack([base, base.T, 1 - base], -1)[None].repeat(2, 0)
    x = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1)
    y = x if kind == "related" else 1 - x
    y = np.clip(y + rng.normal(0, 0.05, x.shape), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("kind", ["related", "anticorrelated"])
@pytest.mark.parametrize("size", [64, 256])
@pytest.mark.parametrize("fn", ["ssim", "ms_ssim"])
def test_metric_and_gradient_match_jax(fn, size, kind):
    x, y = _pair(size, kind)
    want, wgrad = jax.value_and_grad(
        lambda a: getattr(jm, fn)(a, jnp.asarray(y)))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = getattr(pm, fn)(tx, torch.from_numpy(y))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    wgrad = np.asarray(wgrad)
    np.testing.assert_allclose(tx.grad.numpy(), wgrad, rtol=0,
                               atol=1e-4 * np.abs(wgrad).max())
    assert np.isfinite(tx.grad.numpy()).all()
    if fn == "ms_ssim" and kind == "anticorrelated":
        # the floor decides: the terms sit at 1e-4, whose weights sum to 1
        assert got.item() == pytest.approx(1e-4, rel=1e-2)


def test_ms_ssim_floor_and_scale_count():
    """Unrelated images put every term at the 1e-4 floor (value 1e-4, a
    finite gradient); at 64 pixels three scales are used, renormalised."""
    x, _ = _pair(64, "related")
    tx = torch.tensor(x, requires_grad=True)
    v = pm.ms_ssim(tx, torch.from_numpy(1 - x))
    v.backward()
    assert v.item() == pytest.approx(float(jm.ms_ssim(jnp.asarray(x),
                                                       jnp.asarray(1 - x))))
    assert v.item() == pytest.approx(1e-4, rel=1e-5)
    assert torch.isfinite(tx.grad).all()


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for split, n, hw in (("train", 5, (40, 48)), ("test", 3, (20, 30))):
        (root / split).mkdir()
        for i in range(n):
            arr = (rng.random(hw + (3,)) * 255).astype(np.uint8)
            Image.fromarray(arr).save(root / split / f"{i}.png")
    return str(root)


@pytest.mark.parametrize("split", ["train", "test"])
def test_image_folder_batches_match_jax(image_root, split):
    """Same files, same crops and flips, same order, for two epochs; the
    test split's images are smaller than the patch (zero padding)."""
    kw = dict(patch_size=(32, 32), seed=3)
    port, ref = ImageFolder(image_root, split, **kw), JaxImageFolder(image_root, split, **kw)
    for epoch in (0, 1):
        got = list(port.batches(2, epoch=epoch, num_workers=2, drop_last=False))
        want = list(ref.batches(2, epoch=epoch, num_workers=2, drop_last=False))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    batches = list(prefetch_to_device(port.batches(2, epoch=0, num_workers=1),
                                      "cpu"))
    assert all(isinstance(b, torch.Tensor) and b.shape == (2, 32, 32, 3)
               for b in batches)


@pytest.mark.parametrize("metric", ["mse", "ms-ssim"])
def test_rate_distortion_loss_matches_jax(metric):
    """Both distortion terms and the bpp sum over the likelihood dict, at
    a 64x64 batch of 2 with seeded likelihoods."""
    from stf_tpu.training.losses import rate_distortion_loss as jax_loss
    from stf_tpu_torch.training import rate_distortion_loss

    x, y = _pair(64, "related")
    rng = np.random.default_rng(2)
    lik = {"y": rng.uniform(1e-3, 1, (2, 4, 4, 40)).astype(np.float32),
           "z": rng.uniform(1e-3, 1, (2, 1, 1, 32)).astype(np.float32)}
    want = jax_loss({"x_hat": jnp.asarray(y),
                     "likelihoods": {k: jnp.asarray(v) for k, v in lik.items()}},
                    jnp.asarray(x), 0.013, metric)
    got = rate_distortion_loss(
        {"x_hat": torch.from_numpy(y),
         "likelihoods": {k: torch.from_numpy(v) for k, v in lik.items()}},
        torch.from_numpy(x), 0.013, metric)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
