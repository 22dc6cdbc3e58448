"""The port's eval CLI on the small STF (embed 16, depths 1/1/2/1, head
width 16) against the JAX CLI's, on the CPU, at the same weights, with
the host coder over two 64x64 images and a 70x90 one that pads: bpp
equal, PSNR within 1e-4 dB and MS-SSIM within 1e-5 (as for the WACNN,
tests/test_torch_eval_cli.py)."""

from stf_tpu.cli import eval_model as jax_cli
from stf_tpu_torch.cli import eval_model as cli

from _torch_cli import HOST_TOL, close, write_images
from _torch_port import one_torch_thread, pair_from_port  # noqa: F401


def test_stf_host_coder_matches_jax(tmp_path):
    files = cli.collect_images(write_images(tmp_path))
    jm, params, port = pair_from_port(seed=5, name="stf")
    want = jax_cli.eval_model(jm, params, files,
                              recon_path=str(tmp_path / "jax"))
    got = cli.eval_model(port, files, recon_path=str(tmp_path / "port"),
                         device="cpu")
    close(got, want, exact=("bpp",), tol=HOST_TOL)
