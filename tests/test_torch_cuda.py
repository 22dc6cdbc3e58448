"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`; they skip where torch sees no CUDA device. They
import no JAX, so on a machine without it they run with
`python -m pytest --noconftest -q tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

from stf_tpu_torch import _native
from stf_tpu_torch.ans import lane_coder as lc
from stf_tpu_torch.entropy import build_gc_tables, get_scale_table
from stf_tpu_torch.layers import shifted_window_region_labels
from stf_tpu_torch.layers import attention_core as ac

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(dev, ws, hd, shifted, hw_windows=(2, 3), seed=0):
    nh, N = 8, ws * ws
    C = nh * hd
    H, W = hw_windows[0] * ws, hw_windows[1] * ws
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(2, H, W, 3 * C, device=dev, generator=g)
    bias = torch.randn(nh, N, N, device=dev, generator=g)
    labels = None
    if shifted:
        labels = torch.from_numpy(
            shifted_window_region_labels(H, W, ws, ws // 2)
        ).to(dev)
    return qkv, bias, labels


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ws,hd", [(8, 24), (4, 40)])
def test_window_attention_kernel_matches_plain(dev, ws, hd, shifted):
    qkv, bias, labels = _attn_inputs(dev, ws, hd, shifted)
    before = _native.launch_counts[f"window_attention_ws{ws}_hd{hd}"]
    out = ac.window_attention(qkv, bias, labels, ws, hd ** -0.5)
    plain = ac.window_attention_plain(qkv, bias, labels, ws, hd ** -0.5)
    torch.cuda.synchronize()
    assert _native.launch_counts[f"window_attention_ws{ws}_hd{hd}"] == before + 1
    assert (out - plain).abs().max().item() <= 1e-5


def test_window_attention_rejects_bad_inputs(dev):
    qkv, bias, labels = _attn_inputs(dev, 4, 40, True)
    with pytest.raises(TypeError):
        ac.window_attention(qkv.double(), bias, labels, 4, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ac.window_attention(qkv.transpose(1, 2), bias, labels, 4, 0.1)
    with pytest.raises(ValueError, match="labels"):
        ac.window_attention(qkv, bias, labels[:1], 4, 0.1)
    with pytest.raises(ValueError, match="no window_attention kernel"):
        ac.window_attention(qkv, bias[:4], labels, 4, 0.1)  # hd 80


@pytest.fixture(scope="module")
def tables():
    full = build_gc_tables(get_scale_table())
    return lc.truncate_tables(*full.astuple(), max_half=62)


def _lane_args(stream, idx, tables, dev):
    words = lc.pack_word_banks(stream, lc.words_rows_for(stream.word_counts.max()))
    side = lc.pad_side_banks(stream, lc.side_rows_for(stream.side_counts.max()))
    return (
        torch.from_numpy(idx).to(dev), torch.from_numpy(words).to(dev),
        torch.from_numpy(side).to(dev), lc.states_tensor(stream, dev),
        *lc.table_tensors(tables, dev), stream.n,
    )


# escapes; n not a multiple of 128; n < 1024; a single full row
@pytest.mark.parametrize("n,n_escape", [(5000, 300), (3077, 0), (700, 5), (128, 1)])
def test_lane_decode_kernel_is_symbol_exact(dev, tables, n, n_escape):
    rng = np.random.default_rng(n)
    idx = rng.integers(0, 64, n).astype(np.int32)
    sym = np.rint(rng.normal(0, get_scale_table()[idx] * 0.7)).astype(np.int32)
    sym[:n_escape] = rng.integers(63, 5000, n_escape)
    stream = lc.lane_encode(sym, idx, tables)
    args = _lane_args(stream, idx, tables, dev)
    before = _native.launch_counts["lane_decode"]
    out = lc.lane_decode(*args)
    plain = lc.lane_decode_plain(*args)
    torch.cuda.synchronize()
    assert _native.launch_counts["lane_decode"] == before + 1
    np.testing.assert_array_equal(out.cpu().numpy(), sym)
    np.testing.assert_array_equal(plain.cpu().numpy(), sym)


def test_lane_decode_survives_a_corrupt_stream(dev, tables):
    """Wrong indexes make the decoder read past its banks; it must stay in
    bounds (reads there give 0) and agree with the plain version."""
    rng = np.random.default_rng(1)
    n = 4000
    idx = rng.integers(0, 64, n).astype(np.int32)
    sym = np.rint(rng.normal(0, get_scale_table()[idx])).astype(np.int32)
    stream = lc.lane_encode(sym, idx, tables)
    args = list(_lane_args(stream, idx, tables, dev))
    args[0] = torch.full_like(args[0], 63)  # the widest row everywhere
    out = lc.lane_decode(*args)
    plain = lc.lane_decode_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)


def test_lane_decode_rejects_bad_inputs(dev, tables):
    sym = np.zeros(300, np.int32)
    idx = np.zeros(300, np.int32)
    args = list(_lane_args(lc.lane_encode(sym, idx, tables), idx, tables, dev))
    bad = list(args)
    bad[0] = args[0].long()
    with pytest.raises(TypeError):
        lc.lane_decode(*bad)
    bad = list(args)
    bad[0] = args[0][:-1]
    with pytest.raises(ValueError):
        lc.lane_decode(*bad)
    bad = list(args)
    bad[4] = args[4].cpu()
    with pytest.raises(ValueError):
        lc.lane_decode(*bad)
