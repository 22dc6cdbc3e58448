"""The frozen reference against the program's CPU path at a small size,
and the reference's independence from the program: its shared modules
and every architecture file."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from codecbench.reference import check, weights
from codecbench.reference import models as ref_models

from _tiny import CONFIGS, MODELS

torch.set_num_threads(2)


def _pair(model, dtype):
    from stf_tpu_torch.zoo.registry import models

    cfg = CONFIGS[model]
    meta = ref_models.build(model, cfg["arch"], dtype, device="meta")
    state = weights.make_state_dict(meta, 5, "cpu", cfg["weights"]["scale_lift"],
                                    dtype, cfg["weights"]["gains"])
    port = models[model](**cfg["arch"]).eval()
    port.load_state_dict(state)
    ref = check.reference_model(model, cfg["arch"], state, dtype, "cpu")
    return port, ref


def _close(got, want, rtol=2e-5):
    scale = want.abs().max().item() + 1e-12
    assert (got - want).abs().max().item() <= rtol * scale


@pytest.mark.parametrize("model", MODELS)
@torch.no_grad()
def test_reference_matches_the_program_on_the_cpu(model):
    """Every coding step at float32: analysis, hyper synthesis, each
    slice's mean, scale index and residual prediction, synthesis."""
    port, ref = _pair(model, torch.float32)
    x = torch.rand(2, 3, 64, 128, generator=torch.Generator().manual_seed(1))
    y, z = port.analyze(x)
    y_r, z_r = ref.analyze(x)
    _close(y_r, y)
    _close(z_r, z)
    z_hat = torch.round(z)
    lm, ls = port.hyper_synthesize(z_hat, y.shape[2:])
    lm_r, ls_r = ref.hyper(z_hat, y.shape[2:])
    _close(lm_r, lm)
    _close(ls_r, ls)
    table = ref_models.scale_table()
    support = []
    for i, y_i in enumerate(ref.split(y)):
        mu, idx = port.decode_slice_indexes(i, lm, ls, ref.support(support), table)
        mu_r, scale_r, ms = ref.slice_mu_scale(i, lm, ls, ref.support(support))
        _close(mu_r, mu)
        idx_r = torch.bucketize(scale_r.clamp_min(0.11).contiguous(), table[:-1])
        assert (idx_r != idx).float().mean() < 1e-3
        q = torch.round(y_i - mu)
        y_hat = port.decode_slice_apply(i, lm, ref.support(support), mu, q)
        _close(q + mu_r + ref.lrp(i, ms, q + mu_r), y_hat)
        support.append(y_hat)
    y_hat = torch.cat(support, 1)
    _close(ref.synthesize(y_hat), port.synthesize(y_hat))


@torch.no_grad()
def test_bf16_served_parameters_match_the_codec_synthesis():
    """WACNN's IGDN with parameters served in bf16: the reference's
    reparametrisation in bf16 gives the codec's f32 synthesis."""
    from stf_tpu_torch.models.codec import half_weights

    port, ref = _pair("cnn", torch.bfloat16)
    coding = half_weights(port, torch.bfloat16, "cpu")
    y_hat = torch.randn(2, 32, 4, 8, generator=torch.Generator().manual_seed(2))
    _close(ref.synthesize(y_hat), coding.synthesize(y_hat))


def _arch_models():
    return sorted(f[:-3] for f in os.listdir(ref_models.ARCH_DIR) if f.endswith(".py"))


def test_reference_imports_nothing_of_the_program():
    """The shared modules, and every architecture file built at its
    defaults on the meta device."""
    assert set(MODELS) <= set(_arch_models())
    code = ("import sys; import codecbench.reference.check, "
            "codecbench.reference.weights, codecbench.reference.images; "
            "from codecbench.reference import models; "
            f"[models.build(m, {{}}, device='meta') for m in {_arch_models()!r}]; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=_repo()).stdout.split()
    assert not {"jax", "jaxlib", "flax", "stf_tpu", "stf_tpu_torch"} & set(out)
    assert "torch" in out


@pytest.mark.parametrize("model", _arch_models())
def test_an_architecture_file_imports_only_torch_and_the_shared_parts(model):
    """Nothing of the program: torch, `codecbench.reference.models` and
    the standard library."""
    with open(os.path.join(ref_models.ARCH_DIR, model + ".py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, model
            names.add(node.module)
    assert names, model
    for name in names:
        top = name.split(".")[0]
        assert (name == "codecbench.reference.models" or top == "torch"
                or top in sys.stdlib_module_names), name


def _repo():
    import os
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
