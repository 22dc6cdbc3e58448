"""The port's RD tooling and checkpoints against the JAX package's, on the
CPU: `utils/bdrate.py` and `zoo/published.py` (the port's own copies),
`cli/rd_compare.py`, and `zoo/checkpoint.py`.

Tolerances: the BD tools run the JAX package's numpy code on the same
float64 inputs, rtol 1e-12. rd_compare on the same two port checkpoints
and image folder (the JAX CLI reads the port's `.pth.tar` itself): bpp
equal (host coder, byte-identical streams), quality within 1e-4 dB (f32
x_hat within 1e-4, tests/test_torch_codec.py), BD-rate within 1e-6 %
and BD-quality within 1e-4 dB (seen: 1e-7 dB apart in PSNR). The JAX
forward of the port's checkpoint within 1e-4 of the port's (as
tests/test_torch_codec.py holds the eval forward).
"""

import json

import jax
import numpy as np
import pytest
import torch

from stf_tpu.cli import rd_compare as jax_rd
from stf_tpu.utils import bdrate as jax_bd
from stf_tpu.zoo import load_any_checkpoint as jax_load_any
from stf_tpu.zoo import registry as jax_registry
from stf_tpu.zoo.published import PUBLISHED_RD as JAX_PUBLISHED
from stf_tpu_torch.cli import eval_model as cli
from stf_tpu_torch.cli import rd_compare
from stf_tpu_torch.models import WACNN
from stf_tpu_torch.utils import bdrate
from stf_tpu_torch.zoo import load_any_checkpoint, load_checkpoint, models
from stf_tpu_torch.zoo.published import PUBLISHED_RD

from _torch_cli import jax_small_entry, port_model, save_port_checkpoint
from _torch_port import SMALL, one_torch_thread, smooth_images  # noqa: F401

# a wide PSNR curve every seed-weight point lies inside (their PSNR is
# ~6-8 dB at 3-4 bpp): BD integration needs overlapping curves
WIDE = {"bpp": [0.5, 2.0, 8.0, 32.0], "quality": [2.0, 5.0, 8.0, 11.0]}


def _curves(seed):
    r = np.random.default_rng(seed)
    bpp = np.sort(r.uniform(0.1, 1.0, 6))
    return [bpp, np.sort(r.uniform(28, 38, 6)),
            np.sort(r.uniform(0.1, 1.0, 4)) * r.uniform(0.8, 1.2),
            np.sort(r.uniform(29, 37, 4))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bd_tools_match_jax(seed):
    curves = _curves(seed)
    for fn in ("bd_rate", "bd_quality"):
        got, want = getattr(bdrate, fn)(*curves), getattr(jax_bd, fn)(*curves)
        np.testing.assert_allclose(got, want, rtol=1e-12)
    args = curves[0], curves[1], 0.4, float(np.mean(curves[1]))
    np.testing.assert_allclose(bdrate.rate_delta_at_quality(*args),
                               jax_bd.rate_delta_at_quality(*args),
                               rtol=1e-12)


@pytest.mark.parametrize("fn,args,match", [
    ("bd_rate", ([0.1], [30.0], [0.1, 0.2], [30.0, 31.0]), "at least 2"),
    ("bd_rate", ([0.1, 0.2], [30.0, 31.0], [0.1, 0.2], [32.0, 33.0]),
     "do not overlap in quality"),
    ("bd_quality", ([0.1, 0.2], [30.0, 31.0], [0.3, 0.4], [30.0, 31.0]),
     "do not overlap in rate"),
    ("rate_delta_at_quality", ([0.1, 0.2], [30.0, 31.0], 0.1, 50.0),
     "outside the reference curve"),
])
def test_bd_tools_raise_as_jax(fn, args, match):
    for mod in (bdrate, jax_bd):
        with pytest.raises(ValueError, match=match):
            getattr(mod, fn)(*args)


def test_published_curves_equal_jax():
    assert PUBLISHED_RD == JAX_PUBLISHED


def test_load_baseline_picks_the_metric_as_jax(tmp_path):
    blobs = {
        "ms.json": {"results": {"bpp": [0.1, 0.2], "ms-ssim": [13.6, 15.0]}},
        "ps.json": {"results": {"bpp": [0.1, 0.2], "psnr": [29.1, 30.5]}},
        "own.json": {"bpp": [0.1, 0.2], "quality": [29.0, 30.0]},
    }
    for name, blob in blobs.items():
        (tmp_path / name).write_text(json.dumps(blob))
    for spec in [str(tmp_path / n) for n in blobs] + ["cnn_ms-ssim_Kodak",
                                                       "stf_mse_CLIC"]:
        assert rd_compare.load_baseline(spec) == jax_rd.load_baseline(spec)
    assert rd_compare.load_baseline(str(tmp_path / "ms.json"))["metric"] == \
        "ms-ssim-db"


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two port checkpoints of the small WACNN (seeds 8 and 9) and a folder
    of one 64x64 image."""
    from PIL import Image

    root = tmp_path_factory.mktemp("rd")
    (root / "img").mkdir()
    Image.fromarray(smooth_images(1, 64, 64, 4)[0]).save(root / "img" / "a.png")
    paths = [save_port_checkpoint(root / f"cnn_{s}.pth.tar",
                                  port_model(s), "cnn")
             for s in (8, 9)]
    (root / "wide.json").write_text(json.dumps(WIDE))
    return root, paths


def test_rd_compare_matches_jax(checkpoints, monkeypatch, capsys):
    root, paths = checkpoints
    monkeypatch.setitem(jax_registry.models, "cnn", jax_small_entry("cnn"))
    argv = ["-a", "cnn", "-d", str(root / "img"), "-p", *paths,
            str(root / "missing.pth.tar"), "--baseline", str(root / "wide.json"),
            "--recon-path", str(root / "recon")]
    assert rd_compare.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "skipping missing checkpoint" in out.err
    got = json.loads(out.out)
    assert jax_rd.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    print(got, want, sep="\n")
    assert got.keys() == want.keys()
    for k in ("name", "dataset", "baseline", "metric"):
        assert got[k] == want[k]
    assert got["results"]["bpp"] == want["results"]["bpp"]
    np.testing.assert_allclose(got["results"]["psnr"],
                               want["results"]["psnr"], atol=1e-4, rtol=0)
    assert abs(got["bd_rate_pct"] - want["bd_rate_pct"]) <= 1e-6
    assert abs(got["bd_quality_db"] - want["bd_quality_db"]) <= 1e-4


def test_rd_compare_one_point_and_no_points(checkpoints, capsys):
    root, paths = checkpoints
    argv = ["-a", "cnn", "-d", str(root / "img"), "--baseline",
            str(root / "wide.json"), "--device", "cpu",
            "--recon-path", str(root / "recon1")]
    assert rd_compare.main(argv + ["-p", paths[0]]) == 0
    out = json.loads(capsys.readouterr().out)
    (bpp,), (q,) = out["results"]["bpp"], out["results"]["psnr"]
    assert out["rate_delta_pct"] == bdrate.rate_delta_at_quality(
        WIDE["bpp"], WIDE["quality"], bpp, q)
    none = ["-a", "cnn", "-d", str(root / "img"), "-p", "nope.pth.tar"]
    assert rd_compare.main(none) == 0  # before any device is resolved
    got = capsys.readouterr()
    assert jax_rd.main(none) == 0
    assert json.loads(got.out) == json.loads(capsys.readouterr().out) == {
        "name": "cnn", "results": None, "note": "no checkpoints present"}
    assert "skipping missing checkpoint: nope.pth.tar" in got.err


def test_rd_compare_rejects_msssim_with_estimation(checkpoints, capsys):
    root, paths = checkpoints
    assert rd_compare.main(["-a", "cnn", "-d", str(root / "img"), "-p",
                            paths[0], "--baseline", "cnn_ms-ssim_Kodak",
                            "--entropy-estimation", "--device", "cpu"]) == 1
    assert "computes no MS-SSIM" in capsys.readouterr().err


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_checkpoint_round_trip_is_strict(tmp_path):
    port = port_model(10)
    path = save_port_checkpoint(tmp_path / "m.pth.tar", port, "cnn")
    assert json.loads(open(path + ".json").read()) == {"model": "cnn",
                                                       "kwargs": SMALL}
    loaded = load_checkpoint(path, device="cpu")
    assert isinstance(loaded, WACNN) and not loaded.training
    assert loaded.num_slices == SMALL["num_slices"]
    want = _state(port)
    assert loaded.state_dict().keys() == want.keys()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert load_any_checkpoint(path, "cnn", device="cpu").M == SMALL["M"]

    extra = dict(want, **{"g_a.0.scale": torch.zeros(1)})
    torch.save(extra, tmp_path / "extra.pth.tar")
    missing = {k: v for k, v in want.items() if k != "g_a.0.weight"}
    torch.save(missing, tmp_path / "missing.pth.tar")
    for name, match in (("extra", "Unexpected key"), ("missing", "Missing key")):
        with pytest.raises(RuntimeError, match=match):
            load_checkpoint(str(tmp_path / f"{name}.pth.tar"), "cnn",
                            device="cpu", **SMALL)


def test_reference_layout_loads(tmp_path):
    """A reference-layout file: DataParallel's `module.` prefix, the
    legacy bottleneck ParameterList keys, a legacy `h_s.` key, and the
    buffers the reference registers (CDF tables, scale table, bounds,
    pedestals, relative-position indexes), in a training dict."""
    port = port_model(11)
    want = _state(port)
    sd = {}
    for k, v in want.items():
        for singular, plural in (("._bias", "._biases."),
                                 ("._matrix", "._matrices."),
                                 ("._factor", "._factors.")):
            head, _, idx = k.rpartition(singular)
            if head and idx.isdigit():
                k = f"{head}{plural}{idx}"
        sd["module." + k] = v
    derived = ["entropy_bottleneck._quantized_cdf", "entropy_bottleneck._offset",
               "entropy_bottleneck._cdf_length", "gaussian_conditional.scale_table",
               "gaussian_conditional.lower_bound_scale.bound",
               "entropy_bottleneck.likelihood_lower_bound.bound",
               "g_a.1.beta_reparam.pedestal", "g_a.1.gamma_reparam.lower_bound.bound",
               "g_a.4.conv_b.0.attn.relative_position_index", "h_s.0.weight"]
    for k in derived:
        sd["module." + k] = torch.zeros(3)
    assert "module.entropy_bottleneck._biases.0" in sd
    path = tmp_path / "ref.pth.tar"
    torch.save({"epoch": 5, "state_dict": sd, "loss": 1.0}, path)
    loaded = load_checkpoint(str(path), "cnn", device="cpu", **SMALL)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_trainer_checkpoint_loads_through_the_eval_cli(tmp_path, monkeypatch,
                                                       capsys):
    """The trainer's checkpoint_best.pth.tar names its model in its own
    dict; the eval CLI evaluates it as written."""
    from PIL import Image

    from stf_tpu_torch.training import TrainState
    from stf_tpu_torch.training.checkpoint import save_checkpoint
    from stf_tpu_torch.zoo import create_model

    monkeypatch.setitem(models, "cnn_tiny_test", lambda: WACNN(
        N=16, M=24, num_slices=2, max_support_slices=1))
    state = TrainState(create_model("cnn_tiny_test", seed=0), "cpu")
    save_checkpoint(str(tmp_path), state, 0, 1.0,
                    {"model": "cnn_tiny_test", "lmbda": 0.01,
                     "metric": "mse"}, True, 1.0)
    (tmp_path / "img").mkdir()
    Image.fromarray(smooth_images(1, 64, 64, 5)[0]).save(
        tmp_path / "img" / "a.png")
    ckpt = str(tmp_path / "checkpoint_best.pth.tar")
    assert isinstance(load_checkpoint(ckpt, device="cpu"), WACNN)
    cli.main(["-d", str(tmp_path / "img"), "-a", "cnn_tiny_test", "-p", ckpt,
              "-r", str(tmp_path / "recon"), "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["results"]["bpp"][0] > 0
    assert (tmp_path / "recon" / "a.png").exists()


def test_jax_reads_the_ports_checkpoint(tmp_path, monkeypatch):
    port = port_model(12)
    path = save_port_checkpoint(tmp_path / "m.pth.tar", port, "cnn")
    monkeypatch.setitem(jax_registry.models, "cnn", jax_small_entry("cnn"))
    jmodel, params = jax_load_any(path, "cnn")
    x = smooth_images(1, 64, 64, 6).astype(np.float32) / 255.0
    want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v,
                                             training=False))(params, x)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got["x_hat"].numpy(), np.asarray(want["x_hat"]),
                               atol=1e-4, rtol=0)
    for k in ("y", "z"):
        np.testing.assert_allclose(got["likelihoods"][k].numpy(),
                                   np.asarray(want["likelihoods"][k]),
                                   atol=1e-4, rtol=0)


def test_msgpack_and_pruned_checkpoints_raise(tmp_path):
    with pytest.raises(ValueError, match="reads torch files"):
        load_checkpoint(str(tmp_path / "params.msgpack"), "cnn", device="cpu")
    path = tmp_path / "pruned.pth.tar"
    (tmp_path / "pruned.pth.tar.deps.json").write_text("{}")
    with pytest.raises(NotImplementedError,
                       match="comes with train_gd.s prune_export"):
        load_any_checkpoint(str(path), "cnn", device="cpu")
