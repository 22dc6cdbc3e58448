"""The port's eval CLI with the lane coder against the JAX CLI's, on the
CPU, at the same weights: the small WACNN at batch 2 and pipeline 2 over
a 64x64 pair (one batch of two, two sub-batch walks) and a 70x90 image
(a batch of one, padded). The lane stream is the JAX codec's byte for
byte (tests/test_torch_pipeline.py), so bpp and lane_framing_bpp are
equal; PSNR within 1e-4 dB and MS-SSIM within 1e-5 as for the host coder
(tests/test_torch_eval_cli.py). Also: `--prefetch` carries each next
batch across and changes no metric."""

import pytest

from stf_tpu.cli import eval_model as jax_cli
from stf_tpu_torch.cli import eval_model as cli

from _torch_cli import close, write_images
from _torch_port import one_torch_thread, pair_from_port  # noqa: F401

LANE = dict(backend="lane", batch_size=2, pipeline=2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    images = write_images(tmp_path_factory.mktemp("images"))
    jm, params, port = pair_from_port(seed=6, name="cnn")
    files = cli.collect_images(images)
    want = jax_cli.eval_model(
        jm, params, files, recon_path=str(tmp_path_factory.mktemp("r")),
        **LANE)
    return files, port, want


def test_lane_coder_matches_jax(setup, tmp_path):
    files, port, want = setup
    got = cli.eval_model(port, files, recon_path=str(tmp_path), device="cpu",
                         **LANE)
    close(got, want, exact=("bpp", "lane_framing_bpp"),
          tol={"psnr": 1e-4, "ms-ssim": 1e-5})


@pytest.mark.parametrize("backend", ["host", "lane"])
def test_prefetch_changes_no_metric(setup, tmp_path, backend, monkeypatch):
    """Three batches of one: each compress's hook uploads the next batch,
    which the next iteration codes; the metrics are those of a run
    without the hook."""
    files, port, _ = setup
    started = []
    start = cli._Upload.start
    monkeypatch.setattr(cli._Upload, "start", lambda self, b: (
        started.append(b.shape), start(self, b))[1])
    runs = [cli.eval_model(port, files, recon_path=str(tmp_path / str(p)),
                           device="cpu", backend=backend, prefetch=p)
            for p in (False, True)]
    assert started == [(1, 64, 64, 3), (1, 128, 128, 3)]
    for k, v in runs[0].items():
        if "time" not in k:
            assert runs[1][k] == v, k
