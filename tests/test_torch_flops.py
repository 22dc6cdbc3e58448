"""The port's FLOP and parameter counter (`stf_tpu_torch.utils.flops`):
parameter counts against the JAX package's for all six models, the FLOP
count against an analytic count of a small cnn's convolutions, linears
and attention, B1 counted once on the CPU, and the CLI's line. The card
count equals the CPU's in `tests/test_torch_cuda.py`."""

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from _torch_port import _MODELS, CONFIGS, jax_template
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu.utils.flops import count_params as jax_count_params
from stf_tpu_torch.layers import GDN
from stf_tpu_torch.layers import attention_core as ac
from stf_tpu_torch.layers import shifted_window_region_labels
from stf_tpu_torch.layers.win_attention import WindowAttention
from stf_tpu_torch.models import WACNN
from stf_tpu_torch.utils.flops import b1_flops, count_params, main, model_flops
from stf_tpu_torch.zoo import models

TINY = dict(N=16, M=24, num_slices=2, max_support_slices=1)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_count_params_equals_jax(name):
    port = models[name](**CONFIGS[name])
    jax_model = _MODELS[name][1](**CONFIGS[name])
    assert count_params(port) == jax_count_params(jax_template(jax_model))


def _analytic(model, shape):
    """2 x multiply-adds of every convolution (a transposed one over its
    input pixels; GDN's 1x1 one over its channels), linear and B1 call of
    the eval forward, from hooks."""
    counts = {"convolution": 0, "linear": 0, "window_attention": 0}

    def hook(mod, args, out):
        x = args[0]
        if isinstance(mod, nn.ConvTranspose2d):
            taps = mod.kernel_size[0] * mod.kernel_size[1]
            counts["convolution"] += (2 * x.shape[0] * x.shape[2] * x.shape[3]
                                      * taps * mod.in_channels
                                      * mod.out_channels // mod.groups)
        elif isinstance(mod, nn.Conv2d):
            taps = mod.kernel_size[0] * mod.kernel_size[1]
            counts["convolution"] += (2 * out.numel() // mod.out_channels
                                      * taps * mod.in_channels
                                      // mod.groups * mod.out_channels)
        elif isinstance(mod, GDN):
            C = x.shape[1]
            counts["convolution"] += 2 * x.numel() * C
        elif isinstance(mod, nn.Linear):
            counts["linear"] += 2 * x.numel() // x.shape[-1] * (
                mod.in_features * mod.out_features)
        elif isinstance(mod, WindowAttention):
            B, H, W, C = out.shape
            n = mod.window_size[0] * mod.window_size[1]
            counts["window_attention"] += 2 * (2 * B * H * W * n * C)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear,
                               GDN, WindowAttention))]
    with torch.no_grad():
        model.eval()(torch.zeros(shape), training=False)
    for h in hooks:
        h.remove()
    return counts


def test_model_flops_matches_an_analytic_count():
    model = WACNN(**TINY)
    stats = model_flops(model, (1, 64, 64, 3), "cpu")
    want = _analytic(model, (1, 64, 64, 3))
    by_op = stats["by_op"]
    assert by_op["convolution"] == want["convolution"]
    assert by_op.get("addmm", 0) + by_op.get("mm", 0) == want["linear"]
    assert by_op["window_attention"] == want["window_attention"] > 0
    # the rest: the entropy bottleneck's small matrix products
    rest = stats["flops"] - sum(want.values())
    assert rest == by_op.get("bmm", 0) and 0 < rest < 1e-3 * stats["flops"]
    assert stats["params"] == count_params(model)


@pytest.mark.parametrize("shifted", [False, True])
def test_b1_plain_version_counts_its_formula(shifted):
    """The CPU counter sees B1's plain version at exactly `b1_flops` (so
    taking that out of `aten.bmm` leaves none of B1 behind)."""
    ws, nh, hd = 4, 2, 16
    qkv = torch.randn(2, 8, 12, 3 * nh * hd)
    bias = torch.randn(nh, ws * ws, ws * ws)
    labels = (torch.from_numpy(shifted_window_region_labels(8, 12, ws,
                                                            ws // 2))
              if shifted else None)
    with FlopCounterMode(display=False) as counter:
        ac.window_attention_plain(qkv, bias, labels, ws, hd ** -0.5)
    assert counter.get_total_flops() == b1_flops((2, 8, 12, nh * hd), ws)


def test_b1_counted_once_on_the_cpu():
    """The small STF on the CPU: B1's plain matmuls are taken out of the
    counter's bmm and B1 counted once from its shapes, so the total is
    the counter's own."""
    model = models["stf"](**CONFIGS["stf"])
    stats = model_flops(model, (1, 64, 64, 3), "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.eval()(torch.zeros(1, 64, 64, 3), training=False)
    raw = {str(k).split(".")[-1]: v
           for k, v in counter.get_flop_counts()["Global"].items()}
    b1 = stats["by_op"]["window_attention"]
    assert b1 == _analytic(model, (1, 64, 64, 3))["window_attention"] > 0
    assert stats["by_op"]["bmm"] == raw["bmm"] - b1
    assert stats["flops"] == counter.get_total_flops()


def test_main_prints_its_line(monkeypatch, capsys):
    monkeypatch.setitem(models, "cnn_flops_test", lambda **kw: WACNN(**TINY))
    stats = main(["-a", "cnn_flops_test", "--height", "64", "--width", "64",
                  "--device", "cpu"])
    out = capsys.readouterr().out.strip()
    assert out.startswith(f"cnn_flops_test: params "
                          f"{stats['params'] / 1e6:.2f}M, forward ")
    assert f"({stats['flops']} FLOPs; B1 " in out
    assert out.endswith("@ 64x64 on cpu")


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-a", "cnn", "--height", "64", "--width", "64"])
