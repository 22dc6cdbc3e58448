"""The port's eval CLI (`stf_tpu_torch.cli.eval_model`) against the JAX
package's (`stf_tpu.cli.eval_model`) at the same weights, on the CPU, and
the CLI's own contract; and `prime_cache`.

The JAX side runs each configuration once for the module (its CPU
compiles dominate the file's time). Tolerances, host coder (real
coding, f32): bpp equal (the y and z streams are byte-identical, as
tests/test_torch_codec.py holds); PSNR within 1e-4 dB and MS-SSIM within
1e-5 (the same integers, x_hat from f32 transforms that agree within
1e-4, tests/test_torch_codec.py; seen: 1e-7 dB and 6e-9).
"""

import json
import os

import numpy as np
import pytest
import torch

from stf_tpu.cli import eval_model as jax_cli
from stf_tpu.cli import prime_cache as jax_prime
from stf_tpu_torch.cli import eval_model as cli
from stf_tpu_torch.cli import prime_cache

from _torch_cli import HOST_TOL, close, save_port_checkpoint, write_images
from _torch_port import one_torch_thread, pair_from_port  # noqa: F401


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    return write_images(tmp_path_factory.mktemp("images"))


@pytest.fixture(scope="module")
def pairs():
    return {"cnn": pair_from_port(seed=5, name="cnn")}


@pytest.fixture(scope="module")
def jax_host(images, pairs, tmp_path_factory):
    """JAX's eval_model with the host coder (the small STF's is in
    tests/test_torch_eval_stf.py)."""
    recon = str(tmp_path_factory.mktemp("jax_recon"))
    files = jax_cli.collect_images(images)
    return {name: jax_cli.eval_model(jm, params, files, recon_path=recon)
            for name, (jm, params, _) in pairs.items()}


@pytest.mark.parametrize("hw", [(64, 64), (70, 90), (128, 65), (1, 200)],
                         ids=str)
def test_padding_matches_jax(hw):
    x = np.random.default_rng(0).random((1, *hw, 3), np.float32)
    got, box = cli.pad_to_multiple(x)
    want, jbox = jax_cli.pad_to_multiple(x)
    assert box == jbox and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cli.unpad(got, box), x)
    np.testing.assert_array_equal(cli.unpad(got, box),
                                  jax_cli.unpad(want, jbox))


def test_collect_images_matches_jax(tmp_path, images):
    for name in ("z.PNG", "y.jpeg", "x.txt", "w.tif", "v"):
        (tmp_path / name).write_bytes(b"")
    for root in (str(tmp_path), images):
        assert cli.collect_images(root) == jax_cli.collect_images(root)


def test_host_coder_matches_jax(images, pairs, jax_host, tmp_path):
    _, _, port = pairs["cnn"]
    files = cli.collect_images(images)
    got = cli.eval_model(port, files, recon_path=str(tmp_path), device="cpu")
    close(got, jax_host["cnn"], exact=("bpp",), tol=HOST_TOL)


def _ckpt(tmp_path, pairs):
    return save_port_checkpoint(tmp_path / "cnn.pth.tar", pairs["cnn"][2],
                                "cnn")


def test_main_prints_jax_document_writes_reconstructions_and_trace(
        images, pairs, jax_host, tmp_path, capsys):
    ckpt = _ckpt(tmp_path, pairs)
    recon = tmp_path / "recon"
    cli.main(["-d", images, "-a", "cnn", "-p", ckpt, ckpt, "-r", str(recon),
              "--device", "cpu", "--profile-dir", str(tmp_path / "trace")])
    doc = json.loads(capsys.readouterr().out)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))
    assert doc.keys() == {"name", "description", "results"}
    assert doc["name"] == "cnn" and doc["description"] == "Inference (rans)"
    assert doc["results"].keys() == jax_host["cnn"].keys()
    for k, v in doc["results"].items():
        assert len(v) == 2, k  # one value a checkpoint
    assert doc["results"]["bpp"] == [jax_host["cnn"]["bpp"]] * 2
    from PIL import Image

    for f in cli.collect_images(images):
        x = cli.load_image(f)
        with Image.open(recon / os.path.basename(f)) as im:
            assert im.size == (x.shape[1], x.shape[0]) and im.mode == "RGB"


def test_main_on_an_empty_folder_exits_1(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["-d", str(tmp_path), "-a", "cnn", "-p", "x.pth.tar",
                  "--device", "cpu"])
    assert e.value.code == 1
    assert "no images found" in capsys.readouterr().err


def test_main_unknown_architecture_lists_the_names(images, pairs, tmp_path):
    ckpt = _ckpt(tmp_path, pairs)
    with pytest.raises(KeyError, match="available: cnn, stf"):
        cli.main(["-d", images, "-a", "nope", "-p", ckpt, "--device", "cpu",
                  "-r", str(tmp_path / "r")])


def test_entry_points_default_to_cuda_and_raise_without_a_card(
        images, pairs, tmp_path):
    """eval_model, rd_compare, prime_cache and load_checkpoint target the
    card unless told otherwise, and raise where there is none."""
    from stf_tpu_torch.cli import rd_compare
    from stf_tpu_torch.zoo import load_checkpoint

    ckpt = _ckpt(tmp_path, pairs)
    args = cli.setup_args().parse_args(["-d", images, "-a", "cnn", "-p", ckpt])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    calls = (
        lambda: cli.main(["-d", images, "-a", "cnn", "-p", ckpt,
                          "-r", str(tmp_path / "r")]),
        lambda: rd_compare.main(["-a", "cnn", "-d", images, "-p", ckpt]),
        lambda: prime_cache.main(["-a", "cnn", "-p", ckpt]),
        lambda: load_checkpoint(ckpt),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_flags_are_jax_flags_plus_device():
    def flags(parser):
        return {(a.dest, tuple(a.option_strings), a.default,
                 tuple(a.choices or ()), a.nargs, a.const)
                for a in parser._actions if a.dest != "help"}

    got, want = flags(cli.setup_args()), flags(jax_cli.setup_args())
    assert {f[0] for f in got - want} == {"device"}
    assert not want - got


def test_parse_shapes_matches_jax():
    for spec in ("512x768,768x512", "64X128"):
        assert prime_cache.parse_shapes(spec) == jax_prime.parse_shapes(spec)
    for mod in (prime_cache, jax_prime):
        with pytest.raises(ValueError, match="100x64 is not a x64 bucket"):
            mod.parse_shapes("64x64,100x64")


def test_prime_cache_runs_a_bucket(pairs, tmp_path, capsys):
    ckpt = _ckpt(tmp_path, pairs)
    prime_cache.main(["-a", "cnn", "-p", ckpt, "--shapes", "64x128",
                      "--backend", "lane", "--fused-encode", "--device",
                      "cpu"])
    assert "primed (1, 64, 128, 3) in" in capsys.readouterr().err
