"""The port's eval CLI with --half (real coding through
`Codec(dtype=torch.bfloat16)`) against the JAX CLI's, on the CPU, at the
same weights (the small WACNN, two 64x64 images and a 70x90 one that
pads).

The two packages' bf16 analyses round at other points, so their integers
differ (tests/test_torch_bf16.py), and bpp and PSNR are two draws of
bf16 noise. Tolerances: bpp within a relative 2^-6 (four times bf16's
relative rounding step 2^-8) and PSNR within 0.01 dB; over nine draws
(eight weight seeds on one image set, one on another) the gaps reached
0.74% and 0.0046 dB. The band of tests/test_torch_bf16.py (the port's
distance from JAX's bf16 no more than JAX's bf16 from its f32) does not
hold for these scalars: in two of the nine draws JAX's bf16 bpp happened
to lie closer to the f32 one than the port's did (0.0018 against 0.0052,
0.0042 against 0.0094). The run must also differ from the port's f32
run, which a dropped --half would not.
"""

from stf_tpu.cli import eval_model as jax_cli
from stf_tpu_torch.cli import eval_model as cli

from _torch_cli import close, write_images
from _torch_port import one_torch_thread, pair_from_port  # noqa: F401


def test_half_codec_within_bf16_noise_of_jax(tmp_path):
    files = cli.collect_images(write_images(tmp_path))
    jm, params, port = pair_from_port(seed=7, name="cnn")
    want = jax_cli.eval_model(jm, params, files, half=True,
                              recon_path=str(tmp_path / "jax"))
    got = cli.eval_model(port, files, recon_path=str(tmp_path / "half"),
                         device="cpu", half=True)
    f32 = cli.eval_model(port, files, recon_path=str(tmp_path / "f32"),
                         device="cpu")
    close(got, want)
    print(f"JAX bf16 - port f32: bpp {want['bpp'] - f32['bpp']:.3g}, PSNR "
          f"{want['psnr'] - f32['psnr']:.3g}")
    assert abs(got["bpp"] - want["bpp"]) <= 2 ** -6 * want["bpp"]
    assert abs(got["psnr"] - want["psnr"]) <= 0.01
    assert (got["bpp"], got["psnr"]) != (f32["bpp"], f32["psnr"])
