"""Kernel B1's plain version (`window_attention_plain`, what the wrapper
runs on CPU tensors) against the JAX attention cores, and the port's
WindowAttention against the JAX packed-window module. f32, atol 1e-5:
the cores sum the same products in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu.layers.pallas_attention import _reference_core, pallas_window_attention
from stf_tpu.layers.win_attention import WindowAttention as JaxWindowAttention
from stf_tpu.layers.win_attention import shifted_window_region_labels
from stf_tpu_torch.layers import WindowAttention, window_attention

# (window, head dim) of WACNN's two attention geometries, STF's one and
# TBC's five (head widths that are not a multiple of 8 among them), 8
# heads each
GEOMETRIES = [(8, 24), (4, 40), (4, 16), (8, 4), (8, 6), (8, 8), (8, 10),
              (4, 6)]


def _inputs(ws, hd, shifted, seed=0):
    nh = 8
    C = nh * hd
    H, W = 2 * ws, 3 * ws
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(2, H, W, 3 * C)).astype(np.float32)
    bias = rng.normal(size=(nh, ws * ws, ws * ws)).astype(np.float32)
    labels = (
        shifted_window_region_labels(H, W, ws, ws // 2) if shifted else None
    )
    return qkv, bias, labels


def _partition_np(qkv, ws, nh):
    """(B, H, W, 3C) -> q, k, v (B*nW, nh, N, hd), in NumPy."""
    B, H, W, C3 = qkv.shape
    hd = C3 // 3 // nh
    t = qkv.reshape(B, H // ws, ws, W // ws, ws, 3, nh, hd)
    t = t.transpose(5, 0, 1, 3, 6, 2, 4, 7)
    t = t.reshape(3, -1, nh, ws * ws, hd)
    return t[0], t[1], t[2]


def _unpartition_np(out, B, H, W, ws):
    _, nh, _, hd = out.shape
    out = out.reshape(B, H // ws, W // ws, nh, ws, ws, hd)
    return out.transpose(0, 1, 4, 2, 5, 3, 6).reshape(B, H, W, nh * hd)


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ws,hd", GEOMETRIES)
def test_plain_core_matches_jax_cores(ws, hd, shifted):
    qkv, bias, labels = _inputs(ws, hd, shifted)
    B, H, W, _ = qkv.shape
    scale = hd ** -0.5
    q, k, v = _partition_np(qkv, ws, 8)
    mask = None
    if shifted:
        pair = np.where(labels[:, None, :] != labels[:, :, None], -100.0, 0.0)
        mask = jnp.asarray(np.tile(pair.astype(np.float32), (B, 1, 1)))
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias))
    ref = np.asarray(_reference_core(*args, mask, scale))
    pallas = np.asarray(
        pallas_window_attention(*args, mask, scale, interpret=True)
    )
    got = window_attention(
        torch.from_numpy(qkv), torch.from_numpy(bias),
        None if labels is None else torch.from_numpy(labels), ws, scale,
    ).numpy()
    assert got.shape == (B, H, W, 8 * hd)
    np.testing.assert_allclose(got, _unpartition_np(ref, B, H, W, ws), atol=1e-5)
    np.testing.assert_allclose(
        got, _unpartition_np(pallas, B, H, W, ws), atol=1e-5
    )


@pytest.mark.parametrize("ws,hd", GEOMETRIES)
def test_window_attention_module_matches_packed_jax(ws, hd):
    """The port computes each window on its own; the JAX module packs
    windows into 128-token tiles with a -1e5 cross-window penalty."""
    nh, C = 8, 8 * hd
    H, W = 2 * ws, 4 * ws
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, H, W, C)).astype(np.float32)
    labels = shifted_window_region_labels(H, W, ws, ws // 2)
    p = {
        "qkv": {"kernel": rng.normal(0, 0.1, (C, 3 * C)).astype(np.float32),
                "bias": rng.normal(0, 0.1, 3 * C).astype(np.float32)},
        "proj": {"kernel": rng.normal(0, 0.1, (C, C)).astype(np.float32),
                 "bias": rng.normal(0, 0.1, C).astype(np.float32)},
        "relative_position_bias_table": rng.normal(
            size=((2 * ws - 1) ** 2, nh)
        ).astype(np.float32),
    }
    jm = JaxWindowAttention(dim=C, window_size=(ws, ws), num_heads=nh)
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x), labels=labels))

    port = WindowAttention(C, (ws, ws), nh)
    port.load_state_dict({
        "qkv.weight": torch.tensor(p["qkv"]["kernel"].T),
        "qkv.bias": torch.tensor(p["qkv"]["bias"]),
        "proj.weight": torch.tensor(p["proj"]["kernel"].T),
        "proj.bias": torch.tensor(p["proj"]["bias"]),
        "relative_position_bias_table": torch.tensor(
            p["relative_position_bias_table"]
        ),
    })
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_wrapper_rejects_unsupported_devices():
    qkv, bias, _ = _inputs(4, 40, False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        window_attention(
            torch.from_numpy(qkv).to("meta"), torch.from_numpy(bias), None,
            4, 0.1,
        )
