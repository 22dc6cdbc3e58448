"""The port's eval CLI with --entropy-estimation, in f32 and with --half,
against the JAX CLI's, on the CPU, at the same weights (the small WACNN,
three images: two 64x64 and a 70x90 one that pads).

Tolerances: bpp within a relative 1e-5 (a sum of f32 log-likelihoods in
another order; seen 1.3e-6) and PSNR within 1e-3 dB (seen: 1e-7 dB, and
equal under --half). Under --half the JAX CLI casts every parameter to
bf16 and feeds the f32 image: flax promotes each layer to f32, so the
forward computes in f32 on bf16-rounded weights, with GDN's
reparametrisation and the entropy bottleneck's softplus and tanh in bf16
before promotion; the port's `half_weights(..., bottleneck=True)`
computes the same, which
`test_half_estimation_computes_in_f32_on_rounded_weights` holds.
"""

import pytest
import torch

from stf_tpu.cli import eval_model as jax_cli
from stf_tpu_torch.cli import eval_model as cli
from stf_tpu_torch.layers import GDN
from stf_tpu_torch.models.codec import half_weights

from _torch_cli import close, write_images
from _torch_port import one_torch_thread, pair_from_port  # noqa: F401

RUNS = {
    "estimation": dict(entropy_estimation=True),
    "half estimation": dict(entropy_estimation=True, half=True),
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    images = write_images(tmp_path_factory.mktemp("images"))
    jm, params, port = pair_from_port(seed=7, name="cnn")
    files = cli.collect_images(images)
    recon = str(tmp_path_factory.mktemp("r"))
    want = {k: jax_cli.eval_model(jm, params, files, recon_path=recon, **kw)
            for k, kw in RUNS.items()}
    return files, port, want


def _port(setup, tmp_path, **kw):
    files, port, _ = setup
    return cli.eval_model(port, files, recon_path=str(tmp_path),
                          device="cpu", **kw)


@pytest.mark.parametrize("run", ["estimation", "half estimation"])
def test_estimation_matches_jax(setup, tmp_path, run):
    got, want = _port(setup, tmp_path, **RUNS[run]), setup[2][run]
    close(got, want, tol={"psnr": 1e-3})
    assert abs(got["bpp"] - want["bpp"]) <= 1e-5 * abs(want["bpp"])


def test_half_estimation_computes_in_f32_on_rounded_weights(setup):
    """Every parameter holds its bf16-rounded value; those GDN and the
    bottleneck transform before use are bf16, the rest f32; the model's
    output is f32 and the caller's model stays f32."""
    port = setup[1]
    half = half_weights(port, torch.bfloat16, "cpu", bottleneck=True)
    kept = {f"{n}.{p}" for n, m in half.named_modules()
            if isinstance(m, GDN) for p in ("beta", "gamma")}
    kept |= {f"entropy_bottleneck.{n}"
             for n, _ in half.entropy_bottleneck.named_parameters()
             if n.startswith(("_matrix", "_factor"))}
    assert kept
    mine = dict(port.named_parameters())
    for n, p in half.named_parameters():
        assert p.dtype == (torch.bfloat16 if n in kept else torch.float32), n
        assert torch.equal(p.float(), mine[n].bfloat16().float()), n
        assert mine[n].dtype == torch.float32
    with torch.inference_mode():
        out = half(torch.rand(1, 64, 64, 3))
    assert out["x_hat"].dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in out["likelihoods"].values())
