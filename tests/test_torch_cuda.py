"""The port's CUDA kernels against their plain PyTorch versions, and the
graph replays of the fused decompress and the fused encode tiers, on the
card. Marked `cuda`; they skip where torch sees no CUDA device. They
import no JAX, so on a machine without it they run with
`python -m pytest --noconftest -q tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

import _conv_shapes
import _lane_stress as ls
from stf_tpu_torch import _native
from stf_tpu_torch.ans import lane_coder as lc
from stf_tpu_torch.entropy import build_gc_tables, get_scale_table
from stf_tpu_torch.layers import shifted_window_region_labels
from stf_tpu_torch.layers import attention_core as ac
from stf_tpu_torch.layers import conv_core

pytestmark = pytest.mark.cuda

# B1's compiled (window, head width) instances: WACNN's two, STF's, and
# TBC's four 8x8 widths and its hyper stacks' 4x4 / hd 6
B1_GEOMS = [(8, 24), (4, 40), (4, 16), (8, 4), (8, 6), (8, 8), (8, 10),
            (4, 6)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attn_inputs(dev, ws, hd, shifted, hw_windows=(2, 3), seed=0, batch=2,
                 bias_scale=1.0, nh=8):
    N = ws * ws
    C = nh * hd
    H, W = hw_windows[0] * ws, hw_windows[1] * ws
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(batch, H, W, 3 * C, device=dev, generator=g)
    bias = torch.randn(nh, N, N, device=dev, generator=g) * bias_scale
    labels = None
    if shifted:
        labels = torch.from_numpy(
            shifted_window_region_labels(H, W, ws, ws // 2)
        ).to(dev)
    return qkv, bias, labels


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ws,hd", B1_GEOMS)
def test_window_attention_kernel_matches_plain(dev, ws, hd, shifted):
    qkv, bias, labels = _attn_inputs(dev, ws, hd, shifted)
    before = _native.launch_counts[f"window_attention_ws{ws}_hd{hd}"]
    out = ac.window_attention(qkv, bias, labels, ws, hd ** -0.5)
    plain = ac.window_attention_plain(qkv, bias, labels, ws, hd ** -0.5)
    torch.cuda.synchronize()
    assert _native.launch_counts[f"window_attention_ws{ws}_hd{hd}"] == before + 1
    assert (out - plain).abs().max().item() <= 1e-5


# B1 under autograd (`WindowAttentionFunction`: the kernel forward, the
# closed-form backward in PyTorch ops) against autograd through the plain
# version: each gradient within 1e-5 of the largest plain gradient (f32
# products summed in other orders)
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ws,hd", B1_GEOMS)
def test_window_attention_gradients_match_plain(dev, ws, hd, shifted):
    qkv, bias, labels = _attn_inputs(dev, ws, hd, shifted, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    gout = torch.randn(qkv.shape[:-1] + (qkv.shape[-1] // 3,), device=dev,
                       generator=g)

    def grads(fn):
        q, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        out = fn(q, b, labels, ws, hd ** -0.5)
        return out, torch.autograd.grad(out, (q, b), gout)

    key = f"window_attention_ws{ws}_hd{hd}"
    before = _native.launch_counts[key]
    out, got = grads(ac.window_attention)
    assert _native.launch_counts[key] == before + 1  # the forward is B1
    assert out.grad_fn is not None
    plain, want = grads(ac.window_attention_plain)
    torch.cuda.synchronize()
    assert (out - plain).abs().max().item() <= 1e-5
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    with torch.no_grad():  # no gradient wanted: the kernel alone
        assert ac.window_attention(qkv.requires_grad_(), bias, labels, ws,
                                   hd ** -0.5).grad_fn is None


# batch 1; one window; 15 windows (no multiple of the head group or of a
# tile); the bias x30 on WACNN's full maps at a 512x768 input, logits of
# about +-100, where a softmax without its max subtracted overflows and the
# -100 penalty decides whole rows. There both versions round a logit of
# ~100 to f32 (ulp 7.6e-6); the kernel forms logit - max without that
# rounding, and is the closer of the two to an f64 plain version
# (2.4e-6 against 8.8e-6 at 8x8 on an H100, PERF.md section 6)
@pytest.mark.parametrize("case", ["batch1", "one_window", "odd_windows",
                                  "bias_x30"])
@pytest.mark.parametrize("ws,hd", B1_GEOMS)
def test_window_attention_kernel_edge_cases(dev, ws, hd, case):
    kw = {"batch1": dict(batch=1), "one_window": dict(hw_windows=(1, 1)),
          "odd_windows": dict(hw_windows=(3, 5)),
          "bias_x30": dict(bias_scale=30.0,
                           hw_windows=(128 // ws, 192 // ws) if ws == 8
                           else (32 // ws, 48 // ws))}[case]
    qkv, bias, labels = _attn_inputs(dev, ws, hd, True, seed=7, **kw)
    out = ac.window_attention(qkv, bias, labels, ws, hd ** -0.5)
    again = ac.window_attention(qkv, bias, labels, ws, hd ** -0.5)
    plain = ac.window_attention_plain(qkv, bias, labels, ws, hd ** -0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out - plain).abs().max().item() <= 1e-5
    assert torch.equal(out, again)  # no atomics, a fixed summation order
    if case == "bias_x30":
        exact = ac.window_attention_plain(qkv.double(), bias.double(), labels,
                                          ws, hd ** -0.5)
        err = (out.double() - exact).abs().max().item()
        assert err <= 1e-5
        assert err <= (plain.double() - exact).abs().max().item()


# B1's two designs at TBC's 8x8 geometries (32 heads of widths 4, 6, 8
# and 10): the head group's (the wrapper's) and the window-head design it
# replaced, each against the plain version and deterministic
TBC_WIDTHS = [4, 6, 8, 10]
TBC_DESIGNS = ["window_head", "head_group"]


@pytest.mark.parametrize("design", TBC_DESIGNS)
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("hd", TBC_WIDTHS)
def test_window_attention_tbc_designs_match_plain(dev, hd, shifted, design):
    qkv, bias, labels = _attn_inputs(dev, 8, hd, shifted, hw_windows=(4, 6),
                                     seed=11, nh=32)
    key = ac.launch_key(8, hd)
    before = _native.launch_counts[key]
    out = ac._launch(qkv, bias, labels, 8, hd ** -0.5, design)
    again = ac._launch(qkv, bias, labels, 8, hd ** -0.5, design)
    plain = ac.window_attention_plain(qkv, bias, labels, 8, hd ** -0.5)
    torch.cuda.synchronize()
    assert _native.launch_counts[key] == before + 2
    assert (out - plain).abs().max().item() <= 1e-5
    assert torch.equal(out, again)
    # the wrapper launches the head group's design
    assert torch.equal(ac.window_attention(qkv, bias, labels, 8, hd ** -0.5),
                       ac._launch(qkv, bias, labels, 8, hd ** -0.5,
                                  "head_group"))


# B1's FLOP counters by design: through the wrapper, a launch at TBC's
# analysis geometry (8x8, 32 heads of width 4) counts under the head
# group, one at its hyper geometry (4x4, 32 heads of width 6) under one
# block a (window, head), 4 N B H W C each, in f32 and bf16; a graph's
# capture keeps them apart and its replay adds them to the call's record
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_counts_flops_by_design(dev, monkeypatch, dtype):
    from stf_tpu_torch.utils import tracing

    def inputs(ws, hd, hw_windows):
        qkv, bias, labels = _attn_inputs(dev, ws, hd, True, seed=17, nh=32,
                                         hw_windows=hw_windows)
        return qkv.to(dtype), bias.to(dtype), labels, ws, hd ** -0.5

    tbc = inputs(8, 4, (4, 6))
    hyper = inputs(4, 6, (4, 6))
    flops = {k: 4 * a[3] ** 2 * a[0].numel() // 3 for k, a in
             (("group", tbc), ("window", hyper))}
    ac.window_attention(*tbc)  # loads the library outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode():
        with tracing.capturing(tracing.FlopSums()) as captured, \
                torch.cuda.graph(graph):
            ac.window_attention(*tbc)
    assert (captured.b1_head_group_flops, captured.b1_window_flops) == (
        flops["group"], 0)
    monkeypatch.setattr(tracing._profiler, "_is_profiler_enabled", True)

    class Codec:
        @tracing.traced("encode", "tail")
        def call(self, probe=None):
            with torch.inference_mode():
                ac.window_attention(*tbc)
                ac.window_attention(*hyper)
                graph.replay()
                tracing.replayed(captured)
            return {"symbols": [torch.zeros(1)]}

    Codec().call()
    torch.cuda.synchronize()
    rec = tracing.calls()[-1]
    assert (rec.b1_head_group_flops, rec.b1_window_flops) == (
        2 * flops["group"], flops["window"])


# the edge cases above at TBC's geometries for both designs, and TBC's own
# map (stage 2's 64x96 at 8x8: only the last row and column of windows
# carry mixed labels; the bias x30 makes the -100 penalty decide rows
# there), each region held to the tolerance on its own; labels that are
# all equal take the uniform path and give the bits of no labels. With
# the bias x30 (logits of about +-100) the f32 plain version itself is up
# to ~1e-5 from an f64 one at 32 heads, so those two cases hold both
# designs to the f64 plain version instead: within 1e-5, and no farther
# than the f32 plain version
@pytest.mark.parametrize("design", TBC_DESIGNS)
@pytest.mark.parametrize("case", ["batch1", "one_window", "odd_windows",
                                  "bias_x30", "tbc_map", "uniform_labels"])
@pytest.mark.parametrize("hd", TBC_WIDTHS)
def test_window_attention_tbc_designs_edge_cases(dev, hd, case, design):
    kw = {"batch1": dict(batch=1), "one_window": dict(hw_windows=(1, 1)),
          "odd_windows": dict(hw_windows=(3, 5)),
          "bias_x30": dict(bias_scale=30.0, hw_windows=(16, 24)),
          "tbc_map": dict(bias_scale=30.0, hw_windows=(8, 12)),
          "uniform_labels": dict(hw_windows=(3, 5))}[case]
    qkv, bias, labels = _attn_inputs(dev, 8, hd, True, seed=13, nh=32, **kw)
    scale = hd ** -0.5
    if case == "uniform_labels":
        labels = torch.zeros_like(labels)
    out = ac._launch(qkv, bias, labels, 8, scale, design)
    again = ac._launch(qkv, bias, labels, 8, scale, design)
    plain = ac.window_attention_plain(qkv, bias, labels, 8, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)  # no atomics, a fixed summation order
    if case not in ("bias_x30", "tbc_map"):
        assert (out - plain).abs().max().item() <= 1e-5
    if case == "uniform_labels":
        assert torch.equal(out, ac._launch(qkv, bias, None, 8, scale, design))
    if case in ("bias_x30", "tbc_map"):
        exact = ac.window_attention_plain(qkv.double(), bias.double(), labels,
                                          8, scale)
        err = (out.double() - exact).abs()
        assert err.max().item() <= 1e-5
        assert err.max().item() <= (plain.double() - exact).abs().max().item()
    if case == "tbc_map":
        lab = labels.cpu().numpy()
        mixed = (lab != lab[:, :1]).any(1).reshape(8, 12)
        assert mixed[-1].all() and mixed[:, -1].all()
        assert not mixed[:-1, :-1].any()
        by_window = err.reshape(2, 8, 8, 12, 8, -1).amax((0, 2, 4, 5))
        assert by_window[torch.from_numpy(mixed).to(dev)].max().item() <= 1e-5
        assert by_window[torch.from_numpy(~mixed).to(dev)].max().item() <= 1e-5


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
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(qkv.numel() + 1, device=dev)
        ac.window_attention(flat[1:].view(qkv.shape), bias, labels, 4, 0.1)


# B1's bf16 instances against the bf16 plain version: within one bf16 ulp
# an element (`_bf16.ulp_errors`: the ulp taken at no less than 2^-12 of
# the largest output); both designs of the products, each deterministic
@pytest.mark.parametrize("design", sorted(ac.BF16_DESIGNS))
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("ws,hd", B1_GEOMS)
def test_window_attention_bf16_kernel_matches_plain(dev, ws, hd, shifted,
                                                     design):
    from _bf16 import ulp_errors

    qkv, bias, labels = _attn_inputs(dev, ws, hd, shifted, seed=5,
                                     hw_windows=(4, 6))
    qkv, bias = qkv.to(torch.bfloat16), bias.to(torch.bfloat16)
    key = ac.launch_key(ws, hd, torch.bfloat16)
    before = _native.launch_counts[key]
    out = ac._launch(qkv, bias, labels, ws, hd ** -0.5, design)
    again = ac._launch(qkv, bias, labels, ws, hd ** -0.5, design)
    plain = ac.window_attention_plain(qkv, bias, labels, ws, hd ** -0.5)
    torch.cuda.synchronize()
    assert _native.launch_counts[key] == before + 2
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    assert ulp_errors(out, plain).max().item() <= 1.0
    # the wrapper launches the codec's design
    assert torch.equal(ac.window_attention(qkv, bias, labels, ws, hd ** -0.5),
                       ac._launch(qkv, bias, labels, ws, hd ** -0.5))


# the bf16 instances' three designs at TBC's geometries, 32 heads: each
# within one bf16 ulp of the bf16 plain version and deterministic
@pytest.mark.parametrize("design", ["bf16_mma", "tf32", "head_group"])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("hd", TBC_WIDTHS)
def test_window_attention_bf16_tbc_designs_match_plain(dev, hd, shifted,
                                                       design):
    from _bf16 import ulp_errors

    qkv, bias, labels = _attn_inputs(dev, 8, hd, shifted, seed=17,
                                     hw_windows=(4, 6), nh=32)
    qkv, bias = qkv.to(torch.bfloat16), bias.to(torch.bfloat16)
    out = ac._launch(qkv, bias, labels, 8, hd ** -0.5, design)
    again = ac._launch(qkv, bias, labels, 8, hd ** -0.5, design)
    plain = ac.window_attention_plain(qkv, bias, labels, 8, hd ** -0.5)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    assert ulp_errors(out, plain).max().item() <= 1.0
    assert torch.equal(ac.window_attention(qkv, bias, labels, 8, hd ** -0.5),
                       ac._launch(qkv, bias, labels, 8, hd ** -0.5,
                                  "head_group"))


def test_window_attention_bf16_rejects_mixed_inputs(dev):
    qkv, bias, labels = _attn_inputs(dev, 4, 40, True)
    with pytest.raises(TypeError):
        ac.window_attention(qkv.to(torch.bfloat16), bias, labels, 4, 0.1)
    with pytest.raises(TypeError):
        ac.window_attention(qkv.half(), bias.half(), labels, 4, 0.1)
    with pytest.raises(NotImplementedError, match="bf16"):
        ac.window_attention(qkv.to(torch.bfloat16).requires_grad_(),
                            bias.to(torch.bfloat16), labels, 4, 0.1)


def test_bf16_layer_norm_rounds_once_on_the_card(dev):
    """F.layer_norm on bf16 inputs and weights on the card: the f32
    normalisation rounded once to bf16 (flax's LayerNorm in the JAX bf16
    codec), within one ulp (`_bf16.ulp_errors`: the f32 statistics'
    summation order; an output where the bias cancels the normalised
    value is measured at 2^-12 of the largest, as its own ulp is below
    f32's noise: on an H100, 3 of 786,432 outputs, all within 3.8e-6 of
    zero, lie more than an ulp of their own apart)."""
    from _bf16 import ulp_errors, ulps

    g = torch.Generator(device=dev).manual_seed(2)
    x = (torch.randn(4096, 192, device=dev, generator=g) * 3 + 2).bfloat16()
    w = (torch.rand(192, device=dev, generator=g) + 0.5).bfloat16()
    b = (torch.rand(192, device=dev, generator=g) - 0.5).bfloat16()
    got = torch.nn.functional.layer_norm(x, (192,), w, b, 1e-5)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    want = ((xf - mean) * torch.rsqrt(var + 1e-5) * w.float()
            + b.float()).bfloat16()
    assert got.dtype == torch.bfloat16
    off = ulps(got, want) > 1
    print(f"LayerNorm bf16 on the card: {int(off.sum())} of {got.numel()} "
          "outputs more than one ulp of their own apart, the largest "
          f"{want.float().abs()[off].max().item() if off.any() else 0:.3g}")
    assert ulp_errors(got, want).max().item() <= 1.0


@pytest.mark.parametrize("name", ["cnn", "stf"])
def test_bf16_pipeline2_round_trip(dev, name):
    """The small models (`_small`, He scale) through the bf16 codec at
    pipeline 2 on the card: the fused encode tier (full for WACNN, split
    for STF) captures, checks and replays; its stream decodes fused and
    per-slice to its symbols with bit-equal x_hat, the host coder's x_hat
    (packed drain) is bit-equal to the lane coder's, no tier is demoted
    and no hash falls back. B1 runs in bf16 in the analysis only."""
    import warnings

    from stf_tpu_torch.models import Codec

    model = _small(name, he=True).to(dev)
    x = _pattern(64, 128)
    tier = True if name == "cnn" else "split"
    kw = dict(device=dev, dtype=torch.bfloat16, pipeline=2)
    lane = Codec(model, coder="lane", fused_encode=tier, **kw)
    host = Codec(model, coder="host", **kw)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        first = lane.compress(x)
        before = dict(_native.launch_counts)
        enc = lane.compress(x)
        replay = _lane_launches(before)
        fused = lane.decompress(enc["strings"], enc["shape"])
        lane.fused = False
        walk = lane.decompress(enc["strings"], enc["shape"])
        henc = host.compress(x)
        hdec = host.decompress(henc["strings"], henc["shape"])
    assert first["strings"] == enc["strings"] and enc["strings"][0][0][0] & 1
    assert lane.fused_encode and lane._fused_mode == (
        "full" if tier is True else "split")
    for s, f, w, h in zip(enc["symbols"], fused["symbols"], walk["symbols"],
                          henc["symbols"]):
        assert torch.equal(f, s) and torch.equal(w, s) and torch.equal(h, s)
    assert torch.equal(fused["x_hat"], walk["x_hat"])
    assert torch.equal(hdec["x_hat"], fused["x_hat"])
    assert host._pack_drain
    bf16 = sum(v for k, v in replay.items() if k.endswith("_bf16"))
    f32 = sum(v for k, v in replay.items()
              if k.startswith("window_attention") and not k.endswith("_bf16"))
    assert bf16 == (2 if name == "cnn" else 5) and f32 == 0


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


def _decode_both(dev, tables, stream, idx, words, side):
    args = (
        torch.from_numpy(idx).to(dev), torch.from_numpy(words).to(dev),
        torch.from_numpy(side).to(dev), lc.states_tensor(stream, dev),
        *lc.table_tensors(tables, dev), stream.n,
    )
    before = _native.launch_counts["lane_decode"]
    out = lc.lane_decode(*args)
    plain = lc.lane_decode_plain(*args)
    torch.cuda.synchronize()
    assert _native.launch_counts["lane_decode"] == before + 1
    return out.cpu().numpy(), plain.cpu().numpy()


# the main path's shape with the codec's bucketed banks; every lane
# renormalising on every row (128 words a row: the word ring's worst
# refill); rows of escapes only; 32 rows a group (a multiple of the
# kernel's chunk) and 33
@pytest.mark.parametrize("case", ["main_path", "all_renorm", "all_escapes",
                                  "chunk_multiple", "chunk_multiple_plus_one"])
def test_lane_decode_kernel_on_stress_streams(dev, tables, case):
    sym, idx = {
        "main_path": lambda: ls.gaussian(ls.MAIN_PATH_N, 21),
        "all_renorm": lambda: ls.all_renorm(33 * 1024, 22, tables),
        "all_escapes": lambda: ls.all_escapes(33 * 1024, 23),
        "chunk_multiple": lambda: ls.gaussian(32 * 1024, 24),
        "chunk_multiple_plus_one": lambda: ls.gaussian(33 * 1024, 25),
    }[case]()
    stream = lc.lane_encode(sym, idx, tables)
    if case == "all_renorm":
        np.testing.assert_array_equal(
            stream.word_counts, lc.rows_per_group(sym.size) * lc.K)
    out, plain = _decode_both(dev, tables, stream, idx,
                              *ls.banks(stream, bucket=True))
    np.testing.assert_array_equal(out, sym)
    np.testing.assert_array_equal(plain, sym)


def test_lane_decode_kernel_reads_zeros_past_the_word_bank(dev, tables):
    """A corrupt stream whose word cursor runs past the bank in the rows
    the kernel stages: zeros there, as in the plain version, and with
    random words after the bank the same symbols as the plain version."""
    sym, idx, wrong = ls.corrupt(33 * 1024, 16)
    stream = lc.lane_encode(sym, idx, tables)
    words, side = ls.banks(stream)
    out, plain = _decode_both(dev, tables, stream, wrong, words, side)
    np.testing.assert_array_equal(out, plain)
    out2, plain2 = _decode_both(dev, tables, stream, wrong,
                                ls.past_the_bank(words), side)
    np.testing.assert_array_equal(out2, plain2)
    assert not np.array_equal(out, out2)


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


def _encode_inputs(n, seed, n_escape=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 64, n).astype(np.int32)
    sym = np.rint(rng.normal(0, get_scale_table()[idx] * 0.7)).astype(np.int32)
    sym[:n_escape] = rng.integers(63, 5000, n_escape)
    return sym, idx


def _encode_both(sym, idx, tables, dev, misaligned=False):
    """Kernel B3 and its plain version on the same inputs: every output
    equal. misaligned=True hands the kernel views 4 bytes into their
    storage, which it copies in 4-byte pieces."""
    def put(a):
        if not misaligned:
            return torch.from_numpy(a).to(dev)
        return torch.from_numpy(np.concatenate([a[:1], a])).to(dev)[1:]

    args = (
        put(sym), put(idx),
        *lc.table_tensors(tables, dev), sym.size, int(tables.offsets[0]),
    )
    before = _native.launch_counts["lane_encode"]
    out = lc.lane_encode_device(*args)
    plain = lc.lane_encode_device_plain(*args)
    torch.cuda.synchronize()
    assert _native.launch_counts["lane_encode"] == before + 1
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    return [a.cpu().numpy() for a in out]


# one symbol; escapes with n not a multiple of 128; escapes of 2^24 and more
@pytest.mark.parametrize("case", ["n1", "escapes", "huge_escapes"])
def test_lane_encode_kernel_matches_host_encoder(dev, tables, case):
    n, n_escape = {"n1": (1, 1), "escapes": (5077, 300), "huge_escapes": (3000, 4)}[case]
    sym, idx = _encode_inputs(n, n, n_escape)
    if case == "huge_escapes":
        sym[:4] = [1 << 24, -(1 << 24) - 1, (1 << 31) - 1, -(1 << 31)]
    out = _encode_both(sym, idx, tables, dev)
    assert not out[3][:, 2].any()
    tg, wcap_rows, scap_rows = lc.encode_caps(n)
    got = lc.assemble_from_tails(
        out[0].reshape(lc.GROUPS, wcap_rows, lc.K)[:, :tg],
        out[1].reshape(lc.GROUPS, scap_rows, lc.K), out[2], out[3], n,
    )
    want = lc.lane_encode(sym, idx, tables)
    for field in lc.LaneStream._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_lane_encode_kernel_flags_side_overflow(dev, tables):
    n = 5 * lc.GROUPS * lc.K  # tg = 5: group 0's side channel holds 512
    sym, idx = _encode_inputs(n, 2)
    sym[: 5 * lc.K] = 1000
    out = _encode_both(sym, idx, tables, dev)
    assert out[3][0, 2] == 1 and not out[3][1:, 2].any()


# the main path's shape; every lane renormalising on every row; rows of
# escapes only (every group overflows: the flags equal the plain
# version's); 16 and 17 rows a group (the kernel's chunk, and a one-row
# chunk at the top); a row whose start cursor is the side bank's write
# limit (row 4, and a row later); inputs not 16-byte aligned
@pytest.mark.parametrize("case", ["main_path", "all_renorm", "all_escapes",
                                  "chunk_rows", "chunk_rows_plus_one",
                                  "side_limit_row4", "side_limit_row5",
                                  "misaligned"])
def test_lane_encode_kernel_on_stress_inputs(dev, tables, case):
    sym, idx = {
        "main_path": lambda: ls.gaussian(ls.MAIN_PATH_N, 31),
        "all_renorm": lambda: ls.all_renorm(33 * 1024, 32, tables),
        "all_escapes": lambda: ls.all_escapes(33 * 1024, 33),
        "chunk_rows": lambda: ls.gaussian(16 * 1024, 34),
        "chunk_rows_plus_one": lambda: ls.gaussian(17 * 1024, 35),
        "side_limit_row4": lambda: ls.side_limit(4, 36),
        "side_limit_row5": lambda: ls.side_limit(5, 37),
        "misaligned": lambda: ls.gaussian(17 * 1024 + 77, 38),
    }[case]()
    out = _encode_both(sym, idx, tables, dev, misaligned=case == "misaligned")
    overflow = out[3][:, 2]
    if case == "all_escapes":
        assert overflow.all()
        return
    if case.startswith("side_limit"):
        assert overflow[0] == 1 and not overflow[1:].any()
        side0 = out[1].reshape(lc.GROUPS, -1)[0]
        row = int(case[-1])
        np.testing.assert_array_equal(side0[512:519],
                                      1000 + row * lc.K + np.arange(7))
        assert not side0[519:].any()
        return
    assert not overflow.any()
    tg, wcap_rows, scap_rows = lc.encode_caps(sym.size)
    got = lc.assemble_from_tails(
        out[0].reshape(lc.GROUPS, wcap_rows, lc.K)[:, :tg],
        out[1].reshape(lc.GROUPS, scap_rows, lc.K), out[2], out[3], sym.size,
    )
    want = lc.lane_encode(sym, idx, tables)
    for field in lc.LaneStream._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    if case == "all_renorm":
        np.testing.assert_array_equal(want.word_counts, tg * lc.K)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32,
                                   torch.uint8, torch.int8])
def test_layout_pin_kernel_is_bit_exact(dev, dtype):
    g = torch.Generator().manual_seed(3)
    f = torch.randn(3, 7, 11, 5, generator=g)
    f[0, 0, 0, :3] = torch.tensor([float("nan"), float("inf"), -0.0])
    f.view(torch.int32)[1, 1, 1, 1] = 0x7FC01234
    if dtype in (torch.int32, torch.uint8, torch.int8):
        f = torch.randint(-128, 128, (3, 7, 11, 5), generator=g)
    x = f.to(dtype).to(dev)
    big = torch.randn(2, 37, 45, 70, generator=g).to(dtype).to(dev)
    views = [  # (view, the path pin_plan picks)
        (x, "packed"),
        (x.reshape(-1)[:1], "packed"),
        (x.reshape(-1)[1:], "packed"),  # misaligned for 16-byte words
        (x[:, 1:6, 2:9, :], "general"),  # crops
        (big[:, 3:30, :40, 1:65], "general"),
        (x.permute(0, 3, 1, 2), "transpose"),
        (big.permute(0, 3, 1, 2), "transpose"),  # ragged 32 x 32 tiles
        (x.permute(0, 3, 1, 2)[:, :, 1:6, :3], "general"),
        (x[:, :1].expand(3, 4, 11, 5), "general"),  # stride 0
    ]
    for view, kind in views:
        before = _native.launch_counts["layout_pin"]
        before_kind = _native.launch_counts[f"layout_pin_{kind}"]
        got = lc.layout_pin(view)
        torch.cuda.synchronize()
        assert _native.launch_counts["layout_pin"] == before + 1
        assert _native.launch_counts[f"layout_pin_{kind}"] == before_kind + 1
        assert got.is_contiguous() and got.shape == view.shape
        want = lc.layout_pin_plain(view)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _pattern(h, w, k=0):
    """A (2, h, w, 3) uint8 batch: smooth patterns of frequency k + 1."""
    yy, xx = np.mgrid[0:h, 0:w][:, None, :, :, None] / 64.0
    img = 0.5 + 0.4 * np.sin(2 * np.pi * (k + 1) * xx) * np.cos(
        2 * np.pi * (k + 2) * yy + np.arange(6).reshape(2, 1, 1, 3)
    )
    return (img * 255).round().astype(np.uint8)


def test_consecutive_fused_decompresses_are_independent(dev):
    """Fused decompresses of three different streams: each x_hat equals
    its own per-slice decode, and an earlier result survives the later
    replays (outputs are cloned out of the graph's static buffers). At
    1024 symbols a slice every stream has the same bank buckets, so at
    least two of the three replay one graph. Full width (B1 has
    instances for the full models' head widths only), 64x64 images."""
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.zoo import create_model

    model = create_model("cnn", seed=0)
    with torch.no_grad():
        # at seed weights y barely depends on the image; a larger last
        # analysis conv makes the three streams differ
        model.g_a[7].weight.mul_(100)
    codec = Codec(model, coder="lane", device=dev)
    encs = [codec.compress(_pattern(64, 64, k)) for k in range(3)]
    assert len({e["strings"][0][0] for e in encs}) == 3
    fused = [codec.decompress(e["strings"], e["shape"]) for e in encs]
    kept = fused[1]["x_hat"].clone()
    codec.fused = False
    walks = [codec.decompress(e["strings"], e["shape"]) for e in encs]
    for f, w, e in zip(fused, walks, encs):
        assert torch.equal(f["x_hat"], w["x_hat"])
        for s, d in zip(e["symbols"], f["symbols"]):
            assert torch.equal(s, d)
    assert torch.equal(fused[1]["x_hat"], kept)
    assert not torch.equal(fused[0]["x_hat"], fused[1]["x_hat"])


def test_fused_graphs_share_one_pool_and_stay_bounded(dev):
    """Fused decompresses of streams of six geometries, more than the
    codec keeps graphs for. The graphs share one memory pool, so the five
    later captures (each no larger than the first) reuse what the first
    one's intermediates held: together they reserve less device memory
    than the first decompress did. Without the shared pool each would
    reserve its own. Reserved memory is read after `empty_cache()`, so
    only live tensors and graph pools count (a capture empties the cache
    too). The first stream, whose graph was dropped, decodes again
    (recaptured) to its per-slice walk's x_hat."""
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.models.codec import _GRAPH_CACHE
    from stf_tpu_torch.zoo import create_model

    codec = Codec(create_model("cnn", seed=0), coder="lane", device=dev)
    sizes = [(128, 128), (64, 192), (192, 64), (128, 64), (64, 128), (64, 64)]
    encs = [codec.compress(_pattern(h, w)) for h, w in sizes]

    def settled():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    reserved = [settled()]
    for e in encs:
        codec.decompress(e["strings"], e["shape"])
        reserved.append(settled())
    assert len(codec._graphs) == _GRAPH_CACHE
    first, later = reserved[1] - reserved[0], reserved[-1] - reserved[1]
    print(f"reserved MiB by decompress: {[r / 2**20 for r in reserved]}")
    assert later < first, (first, later)
    again = codec.decompress(encs[0]["strings"], encs[0]["shape"])
    assert len(codec._graphs) == _GRAPH_CACHE
    codec.fused = False
    walk = codec.decompress(encs[0]["strings"], encs[0]["shape"])
    assert torch.equal(again["x_hat"], walk["x_hat"])


def _lane_launches(before):
    """{kernel: launches} since the `before` snapshot of the counts."""
    return {k: v - before.get(k, 0) for k, v in _native.launch_counts.items()
            if v - before.get(k, 0)}


@pytest.mark.parametrize("size", [(64, 64), (128, 192)], ids=str)
@pytest.mark.parametrize("tier", [True, "split"], ids=str)
def test_fused_encode_replay_gives_the_per_slice_stream(dev, tier, size):
    """A tier's first compress captures its graph and decodes the stream
    (self-check); the second replays the graph. Both give the per-slice
    stream from byte 1 on, with the fused-encode flag, and the tier is
    not demoted. A replay call launches B1 twice (analysis; eager in the
    split tier) and B3 once a slice; neither tier's walk pins."""
    import warnings

    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.zoo import create_model

    model = create_model("cnn", seed=0)
    x = _pattern(*size)
    want = Codec(model, coder="lane", device=dev).compress(x)
    codec = Codec(model, coder="lane", device=dev, fused_encode=tier)
    S = model.num_slices
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        first = codec.compress(x)
        before = dict(_native.launch_counts)
        again = codec.compress(x)
    replay = _lane_launches(before)
    for enc in (first, again):
        y, y_want = enc["strings"][0][0], want["strings"][0][0]
        assert y[0] == y_want[0] | 1 and y[1:] == y_want[1:]
        assert enc["strings"][1] == want["strings"][1]
        for a, b in zip(enc["symbols"], want["symbols"]):
            assert torch.equal(a, b)
    assert codec.fused_encode and codec._fused_mode == (
        "full" if tier is True else "split")
    assert len(codec._enc_graphs) == 1
    b1 = sum(v for k, v in replay.items() if k.startswith("window_attention"))
    assert b1 == 2  # split: in its eager analysis, outside the graph
    assert replay.get("lane_encode", 0) == S
    assert replay.get("lane_decode", 0) == 0
    assert replay.get("layout_pin", 0) == 0


@pytest.mark.parametrize("tier", [True, "split"], ids=str)
def test_stf_fused_encode_replay_gives_the_per_slice_stream(dev, tier):
    """The full-width STF at a 128x192 input: a tier's first compress
    (capture and self-check) and its replay give the per-slice stream
    from byte 1 on, the tier is not demoted, and a replay launches B1 (at
    head width 16) once for each of the analysis's 12 blocks and B3 once a
    slice."""
    import warnings

    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.zoo import create_model

    model = create_model("stf", seed=0)
    x = _pattern(128, 192)
    want = Codec(model, coder="lane", device=dev).compress(x)
    codec = Codec(model, coder="lane", device=dev, fused_encode=tier)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        first = codec.compress(x)
        before = dict(_native.launch_counts)
        again = codec.compress(x)
    replay = _lane_launches(before)
    for enc in (first, again):
        y, y_want = enc["strings"][0][0], want["strings"][0][0]
        assert y[0] == y_want[0] | 1 and y[1:] == y_want[1:]
        assert enc["strings"][1] == want["strings"][1]
    assert codec.fused_encode and codec._fused_mode == (
        "full" if tier is True else "split")
    assert replay.get("window_attention_ws4_hd16", 0) == 12
    assert replay.get("lane_encode", 0) == model.num_slices
    dec = codec.decompress(again["strings"], again["shape"])
    assert dec["x_hat"].shape == (2, 128, 192, 3)


def test_stf_decode_replay_keeps_its_shift_labels(dev):
    """The STF's fused decompress graph reads its shift-region labels by
    address. Between two replays of the graph, label tables of 300 other
    map sizes are made, and tensors the size of the graph's own tables
    are filled with another label: a table the cache had let go would
    now hold that label. The second replay's x_hat is bit-equal to the
    first's."""
    from stf_tpu_torch.layers import region_labels
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.zoo import create_model

    codec = Codec(create_model("stf", seed=0), coder="lane", device=dev)
    enc = codec.compress(_pattern(64, 64))
    first = codec.decompress(enc["strings"], enc["shape"])["x_hat"].clone()
    for h in range(1, 21):
        for w in range(1, 16):
            region_labels(4 * h, 4 * w + 400, 4, 2, dev)
    own = [region_labels(n, n, 4, 2, dev) for n in (32, 16, 8, 4)]
    fill = [torch.full_like(t, 7) for t in own for _ in range(64)]
    torch.cuda.synchronize()
    again = codec.decompress(enc["strings"], enc["shape"])["x_hat"]
    assert len(codec._graphs) == 1
    assert torch.equal(again, first)
    del fill


def test_consecutive_fused_compresses_are_independent(dev):
    """Full-tier compresses of three different images replay one graph:
    each gives its own per-slice stream, and an earlier call's symbols
    survive the later replays (outputs are cloned out of the graph)."""
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.zoo import create_model

    model = create_model("cnn", seed=0)
    with torch.no_grad():
        model.g_a[7].weight.mul_(100)  # streams that differ (see above)
    lane = Codec(model, coder="lane", device=dev)
    codec = Codec(model, coder="lane", device=dev, fused_encode=True)
    encs = [codec.compress(_pattern(64, 64, k)) for k in range(3)]
    assert len(codec._enc_graphs) == 1
    assert len({e["strings"][0][0] for e in encs}) == 3
    for k, e in enumerate(encs):
        want = lane.compress(_pattern(64, 64, k))
        assert e["strings"][0][0][1:] == want["strings"][0][0][1:]
        for a, b in zip(e["symbols"] + e["indexes"],
                        want["symbols"] + want["indexes"]):
            assert torch.equal(a, b)


def test_fused_outcomes_are_capture_then_replay(dev):
    """While a profiler records, the first full-tier compress of a shape
    records "capture" (its self-check's decode graph captured inside it)
    and the second "replay"; a decoder codec's first fused decompress of
    the stream records "capture", its second "replay"."""
    from torch.profiler import ProfilerActivity, profile

    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.utils import tracing
    from stf_tpu_torch.zoo import create_model

    model = create_model("cnn", seed=0)
    codec = Codec(model, coder="lane", device=dev, fused_encode=True)
    decoder = Codec(model, coder="lane", device=dev)
    old = tracing.calls()
    last = old[-1].id if old else -1
    with profile(activities=[ProfilerActivity.CPU]):
        encs = [codec.compress(_pattern(64, 64)) for _ in range(2)]
        for _ in range(2):
            decoder.decompress(encs[1]["strings"], encs[1]["shape"])
    calls = [c for c in tracing.calls() if c.id > last]
    assert [(c.phase, c.outcome) for c in calls] == [
        ("encode", "capture"), ("encode", "replay"),
        ("decode", "capture"), ("decode", "replay")]
    assert [s.name for s in calls[0].spans].count("self_check") == 1
    assert "self_check" not in [s.name for s in calls[1].spans]
    assert [(s.kind, s.name) for s in calls[1].spans if s.kind != "stage"] == [
        ("launch", "replay"), ("wait", "meta_fetch"), ("wait", "tails_fetch"),
        ("host", "assemble"), ("host", "pack"), ("host", "z_code")]
    assert [(s.kind, s.name) for s in calls[3].spans if s.kind != "stage"] == [
        ("host", "z_code"), ("host", "unpack"), ("host", "banks_pack"),
        ("host", "upload"), ("launch", "replay"), ("wait", "hash_fetch")]


def test_encode_and_decode_graphs_share_one_pool_and_stay_bounded(dev):
    """Full-tier compresses at six geometries: each captures an encode
    graph and, in its self-check, a decode graph, all in the codec's one
    pool. Each kind keeps `_GRAPH_CACHE`; the five later geometries
    (each no larger than the first) reserve less device memory together
    than the first did. The first geometry, its graph dropped, is
    captured again and gives the same stream. `update()` drops every
    graph and the record of checked configurations."""
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.models.codec import _GRAPH_CACHE
    from stf_tpu_torch.zoo import create_model

    codec = Codec(create_model("cnn", seed=0), coder="lane", device=dev,
                  fused_encode=True)
    sizes = [(128, 128), (64, 192), (192, 64), (128, 64), (64, 128), (64, 64)]

    def settled():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    reserved = [settled()]
    encs = []
    for h, w in sizes:
        encs.append(codec.compress(_pattern(h, w)))
        reserved.append(settled())
    print(f"reserved MiB by compress: {[r / 2**20 for r in reserved]}")
    assert len(codec._enc_graphs) == len(codec._graphs) == _GRAPH_CACHE
    first, later = reserved[1] - reserved[0], reserved[-1] - reserved[1]
    assert later < first, (first, later)
    assert codec._fused_mode == "full" and len(codec._enc_verified) == 6
    again = codec.compress(_pattern(*sizes[0]))
    assert again["strings"] == encs[0]["strings"]
    assert len(codec._enc_graphs) == _GRAPH_CACHE
    codec.update()
    assert not codec._enc_graphs and not codec._graphs
    assert not codec._enc_verified
    assert codec.compress(_pattern(*sizes[0]))["strings"] == encs[0]["strings"]
    assert len(codec._enc_graphs) == len(codec._enc_verified) == 1


class _Replay:
    """A sampler that records its draws (`record`) or hands back recorded
    ones (`replay`), on any device: the CPU and the card draw other
    numbers from one seed."""

    def __init__(self, sampler=None, draws=None):
        self.sampler, self.draws = sampler, draws
        self.recorded = []

    def _next(self, kind, draw, like):
        if self.draws is None:
            t = draw()
            self.recorded.append((kind, t.cpu()))
            return t
        k, t = self.draws.pop(0)
        assert k == kind
        return t.to(like.device)

    def uniform(self, shape, like, batch_axis=0):
        return self._next(
            "u", lambda: self.sampler.uniform(shape, like, batch_axis), like)

    def bernoulli(self, p, shape, like):
        return self._next("b", lambda: self.sampler.bernoulli(p, shape, like),
                          like)

    def gumbel(self, shape, like):
        return self._next("g", lambda: self.sampler.gumbel(shape, like), like)


class _Rounding:
    """`ste_round` for `stf_tpu_torch.models.base` (its rounding of
    z - medians and of each y slice - mu in training) that records each
    call's input and rounded value, or, given the rounded values of a
    recorded run, returns them in its place with the straight-through
    gradient: the step then rounds as the recorded one did."""

    def __init__(self, rounded=None):
        self.rounded = rounded
        self.inputs, self.outputs = [], []

    def __call__(self, x):
        if self.rounded is None:
            r = torch.round(x.detach())
        else:
            r = self.rounded[len(self.outputs)].to(x.device)
        self.inputs.append(x.detach().cpu())
        self.outputs.append(r.cpu())
        return x + (r - x).detach()


def _train_step(model, where, draws=None, dtype=torch.float32):
    """One `make_train_step` step of a copy of `model` on `where` at 64x64,
    batch 2, lambda 0.013, in `dtype`: (loss terms, every parameter's
    gradient on the CPU, B1 launches, the draws it took or recorded)."""
    import copy

    from stf_tpu_torch.training import TrainState, make_train_step

    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.random((2, 64, 64, 3)) * 0.4 + 0.3)
                         .astype(np.float32))
    b1 = lambda: sum(v for k, v in _native.launch_counts.items()  # noqa: E731
                     if k.startswith("window_attention"))
    m = copy.deepcopy(model).to(dtype)
    state = TrainState(m, where, seed=5)
    sampler = state.sampler = _Replay(state.sampler,
                                      None if draws is None else list(draws))
    grads = {}
    update = state.apply_gradients

    def apply_gradients():
        grads.update({n: p.grad.detach().cpu().clone()
                      for n, p in m.named_parameters()})
        update()

    state.apply_gradients = apply_gradients
    before = b1()
    metrics = make_train_step(m, 0.013)(state, x.to(where, dtype))
    if draws is not None:
        assert sampler.draws == []  # the step took every recorded draw
    return ({k: float(v) for k, v in metrics.items()}, grads, b1() - before,
            sampler.recorded if draws is None else draws)


def _step_errors(cpu, card):
    """(each loss term's relative error, each gradient's max abs error
    over the tensor's largest CPU gradient) of the card's step against
    the CPU's. A weight fed only zeros (z_hat at init) has a zero
    gradient on both."""
    (cm, cg), (gm, gg) = cpu[:2], card[:2]
    assert cg.keys() == gg.keys()
    loss_err = {k: abs(gm[k] / cm[k] - 1) for k in cm}
    grad_err = {n: (gg[n] - w).abs().max().item() / (w.abs().max().item() or 1)
                for n, w in cg.items()}
    return loss_err, grad_err


def _small(name, he):
    """The WACNN at its widths (B1's instances at head widths 24 and 40)
    with 4 slices, or the small STF of the CPU tests (head width 16), at
    `init_weights`' scale or at He scale (`he_scale`, the CPU parity
    tests' weights)."""
    from _torch_scale import he_scale
    from stf_tpu_torch.models import SymmetricalTransFormer, WACNN, init_weights

    gen = torch.Generator().manual_seed(0)
    model = init_weights(
        WACNN(num_slices=4, max_support_slices=2) if name == "cnn"
        else SymmetricalTransFormer(embed_dim=16, depths=(1, 1, 2, 1),
                                    num_heads=(1, 2, 4, 8), num_slices=4),
        gen)
    return he_scale(model, gen, name) if he else model


# B1 launches of the small models (`_torch_configs.CONFIGS`) in a compress
# and in a decompress: TBC's analysis 8 + h_a 3 + hyper synthesis 3 + 3,
# then 6 + its synthesis's 8; DYSTF's 10 and 10; none for CC and CC_GD
FAMILY_B1 = {"tbc": (17, 14), "dystf": (10, 10), "cc": (0, 0),
             "cc_gd": (0, 0)}


@pytest.mark.parametrize("name", list(FAMILY_B1))
def test_family_round_trip(dev, name):
    """The small `name` model of the CPU tests (He scale; CC_GD with random
    gates and masks) on the card: the full tier's first compress (capture
    and self-check) and a replay give the per-slice stream from byte 1 on;
    it decodes fused and per-slice, and the host coder round-trips, to the
    same symbols with bit-equal x_hat; no demotion or hash fallback
    (warnings are errors); B1 runs FAMILY_B1's launches a replay and a
    fused decompress (TBC's at head widths 4, 6, 8 and 10 and 4x4 / 6)."""
    import warnings

    from _torch_configs import CONFIGS
    from _torch_scale import he_scale, random_gates
    from stf_tpu_torch.models import Codec, init_weights
    from stf_tpu_torch.zoo import models

    gen = torch.Generator().manual_seed(0)
    model = he_scale(init_weights(models[name](**CONFIGS[name]), gen), gen,
                     name)
    if name == "cc_gd":
        random_gates(model, 1)
    x = _pattern(64, 128)
    want = Codec(model, coder="lane", device=dev).compress(x)
    lane = Codec(model, coder="lane", device=dev, fused_encode=True)
    host = Codec(model, coder="host", device=dev)

    def b1(before):
        return sum(v for k, v in _lane_launches(before).items()
                   if k.startswith("window_attention"))

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        first = lane.compress(x)
        before = dict(_native.launch_counts)
        enc = lane.compress(x)
        replay_b1 = b1(before)
        before = dict(_native.launch_counts)
        fused = lane.decompress(enc["strings"], enc["shape"])
        fused_b1 = b1(before)
        lane.fused = False
        walk = lane.decompress(enc["strings"], enc["shape"])
        henc = host.compress(x)
        hdec = host.decompress(henc["strings"], henc["shape"])
    y, y_want = enc["strings"][0][0], want["strings"][0][0]
    assert first["strings"] == enc["strings"]
    assert y[0] == y_want[0] | 1 and y[1:] == y_want[1:]
    assert lane.fused_encode and lane._fused_mode == "full"
    for s, f, w, h in zip(enc["symbols"], fused["symbols"], walk["symbols"],
                          hdec["symbols"]):
        assert torch.equal(f, s) and torch.equal(w, s) and torch.equal(h, s)
    assert torch.equal(fused["x_hat"], walk["x_hat"])
    assert torch.equal(hdec["x_hat"], fused["x_hat"])
    assert (replay_b1, fused_b1) == FAMILY_B1[name]


# the card's step against the CPU's (cuDNN's f32 convolutions, FFT and
# implicit GEMM, sum in other orders); measured on an H100: loss terms
# within 6.3e-8, gradients within 6.0e-6 of each tensor's largest
LOSS_RTOL_CARD = 1e-5
GRAD_TOL_CARD = 1e-4  # of each tensor's largest CPU gradient


@pytest.mark.parametrize("name", ["cnn", "stf"])
def test_train_step_on_the_card_matches_the_cpu(dev, name):
    """One train step on the card (B1's forward under autograd) and on the
    CPU (the plain version), from the same weights at `init_weights`'
    scale, batch and draws, at 64x64, batch 2: loss terms within
    LOSS_RTOL_CARD, each gradient within GRAD_TOL_CARD of the tensor's
    largest CPU gradient (`_small`'s models)."""
    model = _small(name, he=False)
    cpu = _train_step(model, "cpu")
    card = _train_step(model, "cuda", cpu[3])
    assert cpu[2] == 0 and card[2] == (4 if name == "cnn" else 10)
    loss_err, grad_err = _step_errors(cpu, card)
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
    print(f"{name}: loss terms' relative errors {loss_err}; worst "
          f"gradients {worst}")
    assert all(e <= LOSS_RTOL_CARD for e in loss_err.values()), loss_err
    assert all(e <= GRAD_TOL_CARD for e in grad_err.values()), worst


# At He scale the card's step with cuDNN's convolutions (its f32 FFT and
# implicit-GEMM algorithms) puts y - mu 2.2x farther from an f64 step's than
# the CPU's, and the rate's curvature at the scale floor (~1/0.11^2)
# amplifies that in the last layers of the mean and scale stacks: with the
# CPU's roundings replayed its gradients differed from the CPU's by up to
# 2.1e-4 of a tensor's largest on an H100 (9.7e-5 with cuDNN off, against
# GRAD_TOL_CARD)
GRAD_TOL_CUDNN_HE = 5e-4  # of each tensor's largest CPU gradient


@pytest.mark.parametrize("name", ["cnn", "stf"])
def test_train_step_on_the_card_matches_the_cpu_at_he_scale(dev, name,
                                                              monkeypatch):
    """The same step at He scale (`he_scale`, the CPU parity tests'
    weights), where y - mu spans tens of units and an f32 difference
    between the card's sums and the CPU's can carry a value across a
    rounding boundary: each such flip moves y_hat by 1, and the gradients
    downstream with it. With the CPU's draws, the card runs the step
    with its own rounding, then with the CPU's rounded values replayed
    (`_Rounding`), with cuDNN and without it (PyTorch's own CUDA
    convolutions); an f64 step on the CPU with the same draws and
    roundings shows how far each f32 run's y - mu is from exact. It
    counts the elements the card rounds otherwise than the CPU from the
    same history (the replayed run's inputs) and in its own run.

    Checked, each against the CPU's step: with the rounding replayed,
    the loss terms within LOSS_RTOL_CARD; without cuDNN every gradient
    within GRAD_TOL_CARD, with it within GRAD_TOL_CUDNN_HE; where the
    card's own run rounded every element as the CPU did, its gradients
    within GRAD_TOL_CUDNN_HE too."""
    from stf_tpu_torch.models import base

    model = _small(name, he=True)
    runs = {}
    for run, where, dtype, replay, cudnn in (
            ("cpu", "cpu", torch.float32, False, True),
            ("own", "cuda", torch.float32, False, True),
            ("card", "cuda", torch.float32, True, True),
            ("no_cudnn", "cuda", torch.float32, True, False),
            ("f64", "cpu", torch.float64, True, True)):
        rounding = _Rounding(runs["cpu"][1].outputs if replay else None)
        monkeypatch.setattr(base, "ste_round", rounding)
        monkeypatch.setattr(torch.backends.cudnn, "enabled", cudnn)
        runs[run] = (_train_step(model, where, None if run == "cpu"
                                 else runs["cpu"][0][3], dtype), rounding)
    rec = runs["cpu"][1]
    assert all(len(r.outputs) == len(rec.outputs) for _, r in runs.values())
    own_flips = sum(int((a != b).sum()) for a, b in zip(runs["own"][1].outputs,
                                                         rec.outputs))
    flips, gaps = 0, []
    for x_card, x_cpu, r in zip(runs["card"][1].inputs, rec.inputs,
                                rec.outputs):
        moved = torch.round(x_card) != r
        flips += int(moved.sum())
        gaps += (x_cpu[moved] - x_cpu[moved].floor() - 0.5).abs().tolist()
    drift = {k: max((a.double() - b).abs().max().item() for a, b in
                    zip(runs[k][1].inputs, runs["f64"][1].inputs))
             for k in ("cpu", "card", "no_cudnn")}
    n = sum(r.numel() for r in rec.outputs)
    cpu = runs["cpu"][0]
    errs = {k: _step_errors(cpu, runs[k][0])
            for k in ("own", "card", "no_cudnn")}
    worst = lambda e: sorted(e.items(), key=lambda kv: -kv[1])[:3]  # noqa: E731
    print(f"{name} at He scale: of {n} rounded elements, {flips} round "
          f"otherwise on the card from the CPU's history (their distances "
          f"from a .5 boundary {sorted(gaps)[:8]}), {own_flips} in the "
          f"card's own run; y - mu's largest distance from the f64 step's: "
          f"{drift}. Against the CPU's step, loss terms and worst gradients: "
          + "; ".join(f"{k}: {max(le.values()):.3g}, {worst(ge)}"
                      for k, (le, ge) in errs.items()))
    for k, tol in (("card", GRAD_TOL_CUDNN_HE), ("no_cudnn", GRAD_TOL_CARD)):
        loss_err, grad_err = errs[k]
        assert all(e <= LOSS_RTOL_CARD for e in loss_err.values()), (k, loss_err)
        assert all(e <= tol for e in grad_err.values()), (k, worst(grad_err))
    if own_flips == 0:
        assert all(e <= GRAD_TOL_CUDNN_HE for e in errs["own"][1].values())


# the eval CLI on the card: full-width WACNN (B1 has instances for the full
# models' head widths) and the small STF of tests/_torch_port.py (head width
# 16), over two 64x64 images and a 70x90 one that pads to 128x128
EVAL_MODELS = {"cnn": {}, "stf": dict(embed_dim=16, depths=(1, 1, 2, 1),
                                      num_heads=(1, 2, 4, 8), num_slices=4)}


@pytest.fixture
def eval_images(tmp_path):
    from PIL import Image

    for name, (h, w), k in (("a.png", (64, 64), 0), ("b.png", (64, 64), 1),
                            ("c.png", (70, 90), 2)):
        Image.fromarray(_pattern(h, w, k)[0]).save(tmp_path / name)
    from stf_tpu_torch.cli import eval_model as cli

    return cli.collect_images(str(tmp_path))


def _eval(dev, name, files, recon, **kw):
    import warnings

    from stf_tpu_torch.cli import eval_model as cli
    from stf_tpu_torch.zoo import create_model

    model = create_model(name, seed=0, **EVAL_MODELS[name])
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a demoted tier warns
        return cli.eval_model(model, files, recon_path=str(recon), device=dev,
                              **kw)


@pytest.mark.parametrize("name", ["cnn", "stf"])
def test_eval_cli_lane_and_host_give_equal_quality(dev, name, eval_images,
                                                   tmp_path):
    """The lane and host coders decode the same symbols, so the same
    x_hat: PSNR and MS-SSIM equal."""
    host = _eval(dev, name, eval_images, tmp_path / "h")
    lane = _eval(dev, name, eval_images, tmp_path / "l", backend="lane")
    assert lane["psnr"] == host["psnr"] and lane["ms-ssim"] == host["ms-ssim"]
    assert lane["lane_framing_bpp"] > 0 and "lane_framing_bpp" not in host


@pytest.mark.parametrize("name", ["cnn", "stf"])
def test_eval_cli_half_batched_pipelined_fused_is_not_demoted(
        dev, name, eval_images, tmp_path):
    """--half --batch-size 2 --pipeline 2 --fused-encode 1: the tier's
    self-check passes for both batch shapes (warnings are errors) and the
    quality is that of the f32 codec within 0.05 dB."""
    half = _eval(dev, name, eval_images, tmp_path / "b", backend="lane",
                 half=True, batch_size=2, pipeline=2, fused_encode=True)
    f32 = _eval(dev, name, eval_images, tmp_path / "f", backend="lane")
    assert abs(half["psnr"] - f32["psnr"]) <= 0.05
    assert half["bpp"] > 0 and "first_use_encoding_time" in half


@pytest.mark.parametrize("backend", ["host", "lane"])
def test_eval_cli_prefetch_gives_the_same_metrics(dev, backend, eval_images,
                                                  tmp_path):
    """--prefetch over three batches: each next batch is uploaded on a
    side stream while the current one codes, and the coding stream waits
    for it; the metrics are those of the run without it."""
    runs = [_eval(dev, "cnn", eval_images, tmp_path / str(p), backend=backend,
                  prefetch=p) for p in (False, True)]
    for k, v in runs[0].items():
        if "time" not in k:
            assert runs[1][k] == v, k


def _dytrain_step(student, teacher, where, draws=None):
    """One `make_dytrain_step` (clf_weight 1) of copies of the small DYSTF
    student and STF teacher on `where` at 64x64, batch 2, with the CPU's
    draws replayed when `draws` is given: (loss parts, every student
    gradient on the CPU, B1 launches, the draws)."""
    import copy

    from stf_tpu_torch.training import TrainState, make_dytrain_step

    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.random((2, 64, 64, 3)) * 0.4 + 0.3)
                         .astype(np.float32))
    b1 = lambda: sum(v for k, v in _native.launch_counts.items()  # noqa: E731
                     if k.startswith("window_attention"))
    s, t = copy.deepcopy(student), copy.deepcopy(teacher).to(where)
    t_before = {k: v.clone() for k, v in t.state_dict().items()}
    state = TrainState(s, where, seed=5)
    sampler = state.sampler = _Replay(state.sampler,
                                      None if draws is None else list(draws))
    grads = {}
    update = state.apply_gradients

    def apply_gradients():
        grads.update({n: (torch.zeros_like(p) if p.grad is None else p.grad)
                      .detach().cpu().clone()
                      for n, p in s.named_parameters()})
        update()

    state.apply_gradients = apply_gradients
    before = b1()
    parts = make_dytrain_step(s, t, 0.013, (0.75, 0.5, 0.25),
                              clf_weight=1.0)(state, x.to(where))
    assert all(torch.equal(v, t_before[k]) for k, v in t.state_dict().items())
    if draws is not None:
        assert sampler.draws == []
    return ({k: float(v) for k, v in parts.items()}, grads, b1() - before,
            sampler.recorded if draws is None else draws)


def test_dytrain_step_on_the_card_matches_the_cpu(dev, monkeypatch):
    """A DYSTF distillation step (the student's training routing, the
    frozen teacher's eval forward, B1 under autograd) on the card against
    the same step on the CPU: the small DYSTF of the CPU tests whose
    schedule trains (`DYSTF_TRAIN`) and the small STF teacher, both at He
    scale, the CPU's draws and roundings of y - mu replayed (as the RD
    step's He-scale test does: a rounding that flips on the card moves
    y_hat by 1). Loss parts within LOSS_RTOL_CARD, each gradient within
    GRAD_TOL_CUDNN_HE of its tensor's largest CPU gradient; B1 launched
    30 times (student 10 + 10, teacher 5 + 5); the teacher bit-unchanged."""
    from _torch_configs import DYSTF_TRAIN, STF_SMALL
    from _torch_scale import he_scale
    from stf_tpu_torch.models import DYSTF, SymmetricalTransFormer, base
    from stf_tpu_torch.models import dystf, init_weights

    gen = torch.Generator().manual_seed(6)
    student = he_scale(init_weights(DYSTF(**DYSTF_TRAIN), gen), gen, "dystf")
    teacher = he_scale(init_weights(SymmetricalTransFormer(
        **STF_SMALL, is_teacher=True), gen), gen, "stf")
    hard, masks = dystf.gumbel_softmax_hard, []

    def recorded(*a):
        y = hard(*a)
        masks.append(y.detach().cpu())
        return y

    monkeypatch.setattr(dystf, "gumbel_softmax_hard", recorded)
    rounding = _Rounding()
    monkeypatch.setattr(base, "ste_round", rounding)
    cpu = _dytrain_step(student, teacher, "cpu")
    cpu_masks, masks[:] = masks[:], []
    monkeypatch.setattr(base, "ste_round", _Rounding(rounding.outputs))
    card = _dytrain_step(student, teacher, "cuda", cpu[3])
    assert cpu[2] == 0 and card[2] == 30
    # every stage's keep masks: 1 + 1 + 2, the same tokens on both
    assert len(masks) == len(cpu_masks) == 4
    for a, b in zip(cpu_masks, masks):
        assert torch.equal(a, b)
    loss_err, grad_err = _step_errors(cpu, card)
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
    print(f"dytrain step: loss parts' relative errors {loss_err}; worst "
          f"gradients {worst}")
    assert all(e <= LOSS_RTOL_CARD for e in loss_err.values()), loss_err
    assert all(e <= GRAD_TOL_CUDNN_HE for e in grad_err.values()), worst


def test_pruned_export_round_trip(dev, tmp_path):
    """A small gated CC_GD (random gates, a third of its channels masked,
    z's gate unmasked) exported by `prune_export` and reloaded on the card:
    its eval forward within 1e-5 of the gated model's; through the lane
    coder (fused and per-slice decompress) and the host coder the symbols
    round-trip and x_hat is bit-equal; B2, B3 and B4 launched."""
    import warnings

    from _torch_configs import SMALL
    from _torch_scale import he_scale, random_gates
    from stf_tpu_torch.models import CC_GD, Codec, init_weights
    from stf_tpu_torch.training import iter_gates, load_pruned_checkpoint
    from stf_tpu_torch.training import prune_export

    gen = torch.Generator().manual_seed(0)
    gated = random_gates(he_scale(init_weights(CC_GD(**SMALL), gen), gen,
                                  "cc_gd"), 1).to(dev).eval()
    with torch.no_grad():
        dict(iter_gates(gated))["h_a/gate_2"].mask.fill_(1.0)
    _, deps = prune_export(gated, str(tmp_path))
    pruned = load_pruned_checkpoint(str(tmp_path / "pruned_model.pth.tar"),
                                    dev)
    assert sum(deps.values()) < sum(g.mask.numel()
                                    for _, g in iter_gates(gated))
    x = _pattern(64, 128)
    xf = torch.from_numpy(x).to(dev).float() / 255.0
    with torch.no_grad():
        got, want = pruned(xf), gated(xf)
    assert (got["x_hat"] - want["x_hat"]).abs().max().item() <= 1e-5
    lane = Codec(pruned, coder="lane", device=dev)
    host = Codec(pruned, coder="host", device=dev)
    before = dict(_native.launch_counts)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        enc = lane.compress(x)
        fused = lane.decompress(enc["strings"], enc["shape"])
        lane.fused = False
        walk = lane.decompress(enc["strings"], enc["shape"])
        henc = host.compress(x)
        hdec = host.decompress(henc["strings"], henc["shape"])
    ran = _lane_launches(before)
    assert all(ran.get(k, 0) for k in ("lane_decode", "lane_encode",
                                        "layout_pin")), ran
    for s, f, w, h in zip(enc["symbols"], fused["symbols"], walk["symbols"],
                          henc["symbols"]):
        assert torch.equal(f, s) and torch.equal(w, s) and torch.equal(h, s)
    assert torch.equal(fused["x_hat"], walk["x_hat"])
    assert torch.equal(hdec["x_hat"], fused["x_hat"])


@pytest.mark.parametrize("name,config", [("cnn", {}),
                                         ("stf", "STF_SMALL")])
def test_flop_count_on_the_card_equals_the_cpu(dev, name, config):
    """`utils.flops.model_flops` on the card, where B1's launch is
    invisible to torch's counter and is counted from its shapes, equals
    the CPU's count, where B1's plain matmuls are taken out (the
    full-width cnn and the small STF at 64x64)."""
    import _torch_configs
    from stf_tpu_torch.utils.flops import model_flops
    from stf_tpu_torch.zoo import models

    kwargs = getattr(_torch_configs, config) if config else {}
    cpu = model_flops(models[name](**kwargs), (1, 64, 64, 3), "cpu")
    card = model_flops(models[name](**kwargs), (1, 64, 64, 3), dev)
    assert card["flops"] == cpu["flops"]
    assert card["by_op"]["window_attention"] == cpu["by_op"][
        "window_attention"] > 0
    assert card["by_op"]["convolution"] == cpu["by_op"]["convolution"]


# -- the 3xTF32 convolution kernel (`layers.conv_core`) ----------------------


def _conv_inputs(dev, ci, co, k, h, w, batch, seed=0):
    """x (batch, ci, h, w), weight (co, ci, k, k) at torch's default scale
    and a bias, from one seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, ci, h, w, device=dev, generator=g)
    wt = torch.randn(co, ci, k, k, device=dev, generator=g) / (ci * k * k) ** 0.5
    return x, wt, torch.randn(co, device=dev, generator=g)


@pytest.mark.parametrize(
    "shape", _conv_shapes.routed() + _conv_shapes.routed(transposed=True),
    ids=str)
def test_conv_tc_matches_f64_within_4x_cudnn_f32(dev, shape):
    """The kernel at every shape the benchmark's cells route to it (512x768
    and 768x512), and at a pruned CC_GD's odd widths: its largest error
    against an f64 convolution is at most 4x that of cuDNN's f32
    convolution (TF32 off) at the same inputs; one launch a call."""
    import torch.nn.functional as F

    from stf_tpu_torch.utils.numerics import use_numerical_policy

    use_numerical_policy()
    ci, co, k, h, w = shape
    x, wt, b = _conv_inputs(dev, ci, co, k, h, w, 2 if h * w <= 6144 else 1)
    key = conv_core.launch_key(k)
    assert torch.equal(conv_core.pack_weight(wt),
                       conv_core.pack_weight_plain(wt))
    before = _native.launch_counts[key]
    got = conv_core.conv2d_tc(x, wt, b)
    want = F.conv2d(x.double(), wt.double(), b.double(), padding=k // 2)
    cudnn = F.conv2d(x, wt, b, padding=k // 2)
    torch.cuda.synchronize()
    assert _native.launch_counts[key] == before + 1
    err = (got.double() - want).abs().max().item()
    ref = (cudnn.double() - want).abs().max().item()
    print(f"{shape}: kernel {err:.3g}, cuDNN f32 {ref:.3g}")
    assert err <= 4 * ref, (err, ref)


@pytest.mark.parametrize("shape", [
    (480, 224, 3, 32, 48), (176, 128, 3, 32, 48), (320, 160, 1, 32, 48),
    (256, 1152, 3, 16, 24), (48, 192, 5, 64, 96), (48, 3, 3, 64, 96),
    (61, 37, 3, 32, 48)], ids=str)
def test_conv_tc_is_bitwise_batch_and_configuration_invariant(dev, shape):
    """An image's outputs at batch 24 equal, bit for bit, its outputs alone
    and the batch's outputs under every tile configuration: each output's
    sum runs in an order fixed by C_in and k alone."""
    ci, co, k, h, w = shape
    x, wt, b = _conv_inputs(dev, ci, co, k, h, w, 24, seed=1)
    y = conv_core.conv2d_tc(x, wt, b)
    for i in range(x.shape[0]):
        assert torch.equal(conv_core.conv2d_tc(x[i:i + 1], wt, b), y[i:i + 1])
    for config in range(len(conv_core.CONFIGS)):
        assert torch.equal(conv_core.conv2d_tc(x, wt, b, config=config), y)


def test_conv_tc_replays_in_a_graph_as_it_runs_eagerly(dev):
    """A captured launch replayed on new inputs gives the eager launch's
    bits; the kernel allocates nothing and does not synchronise, so it
    captures as cuDNN's calls do."""
    x, wt, b = _conv_inputs(dev, 352, 224, 3, 32, 48, 4, seed=2)
    x2 = torch.randn_like(x)
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv_core.conv2d_tc(static, wt, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv_core.conv2d_tc(static, wt, b)
    for inp in (x, x2):
        static.copy_(inp)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, conv_core.conv2d_tc(inp, wt, b))


def test_conv2d_routes_on_the_card(dev):
    """`Conv2d` launches the kernel for an f32 stride-1 call in inference
    mode (a non-contiguous input made contiguous first; its weight's
    packing kept until the weight changes in place) and not under
    autograd (training), in bf16 or at stride 2, which reach cuDNN."""
    from stf_tpu_torch.layers import Conv2d

    layer = Conv2d(8, 16, 3, padding=1).to(dev)
    x = torch.randn(2, 8, 10, 12, device=dev)
    key = conv_core.launch_key(3)

    def launched(fn):
        before = _native.launch_counts[key]
        out = fn()
        torch.cuda.synchronize()
        return out, _native.launch_counts[key] - before

    with torch.inference_mode():
        got, n = launched(lambda: layer(x))
        assert n == 1
        t, n = launched(lambda: layer(x.transpose(2, 3)))
        assert n == 1 and torch.equal(t, conv_core.conv2d_tc(
            x.transpose(2, 3).contiguous(), layer.weight, layer.bias))
        packs = _native.launch_counts["conv_tc_pack"]
        layer(x)
        assert _native.launch_counts["conv_tc_pack"] == packs
    with torch.no_grad():
        layer.weight.mul_(2.0)
    with torch.inference_mode():
        twice, n = launched(lambda: layer(x))
        assert n == 1 and _native.launch_counts["conv_tc_pack"] == packs + 1
        assert torch.equal(twice, conv_core.conv2d_tc(x, layer.weight,
                                                      layer.bias))
    with torch.no_grad():
        layer.weight.mul_(0.5)
    with torch.inference_mode():
        assert torch.equal(layer(x), got)
    train, n = launched(lambda: layer(x))
    assert n == 0 and train.requires_grad
    assert (train.detach() - got).abs().max().item() <= 1e-5
    with torch.inference_mode():
        _, n = launched(lambda: layer.to(torch.bfloat16)(x.bfloat16()))
        assert n == 0
        strided = Conv2d(8, 16, 3, stride=2, padding=1).to(dev)
        _, n = launched(lambda: strided(x))
        assert n == 0


def test_conv_tc_rejects_bad_inputs(dev):
    """Other dtypes, non-contiguous operands, unknown configurations (the
    Python table mirrors the library's) and kernel sizes raise."""
    assert _native.load("convtc").stf_conv_tc_configs() == len(conv_core.CONFIGS)
    x, wt, b = _conv_inputs(dev, 8, 16, 3, 10, 12, 2)
    with pytest.raises(TypeError):
        conv_core.conv2d_tc(x.double(), wt.double(), b.double())
    with pytest.raises(ValueError):
        conv_core.conv2d_tc(x.transpose(2, 3), wt, b)
    with pytest.raises(ValueError):
        conv_core.conv2d_tc(x, wt[:, :4], b)
    with pytest.raises(ValueError):
        conv_core.conv2d_tc(x, wt, b, config=len(conv_core.CONFIGS))
    with pytest.raises(ValueError):
        conv_core.conv2d_tc(x, torch.zeros(16, 8, 7, 7, device=dev), b)


@pytest.mark.parametrize("batch", [24, 1])
@pytest.mark.parametrize("name", ["cnn", "stf"])
def test_round_trip_through_the_conv_kernel(dev, name, batch):
    """The full-width WACNN and STF (STF's scale stacks lifted as the
    smoke lifts them) at 128x192: the full tier's compress (its first
    call: capture and self-check) and a replay, then another codec's
    fused and per-slice decompress, give the encoder's symbols; x_hat
    fused = per-slice; the kernel launches in both phases."""
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.zoo import create_model

    model = create_model(name, seed=0)
    if name == "stf":
        with torch.no_grad():
            for stack in model.cc_scale_transforms:
                stack[-1].bias += 1.0
    x = np.concatenate([_pattern(128, 192, k) for k in range(12)])[:batch]
    enc_codec = Codec(model, coder="lane", device=dev, fused_encode=True)
    dec_codec = Codec(model, coder="lane", device=dev)

    def conv_launches(before):
        return sum(v for k, v in _lane_launches(before).items()
                   if k.startswith("conv_tc"))

    enc_codec.compress(x)
    before = dict(_native.launch_counts)
    enc = enc_codec.compress(x)
    enc_launches = conv_launches(before)
    before = dict(_native.launch_counts)
    fused = dec_codec.decompress(enc["strings"], enc["shape"])
    dec_launches = conv_launches(before)
    dec_codec.fused = False
    walk = dec_codec.decompress(enc["strings"], enc["shape"])
    for s, f, w in zip(enc["symbols"], fused["symbols"], walk["symbols"]):
        assert torch.equal(f, s) and torch.equal(w, s)
    assert torch.equal(fused["x_hat"], walk["x_hat"])
    assert enc_launches > 0 and dec_launches > 0, (enc_launches, dec_launches)


# -- the kernel's transposed convolution (`conv_core.conv_transpose2d_tc`) ---


def _deconv_inputs(dev, ci, co, h, w, batch, seed=0):
    """x (batch, ci, h, w), a (ci, co, 5, 5) weight at torch's default
    scale for a transposed convolution, and a bias."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, ci, h, w, device=dev, generator=g)
    wt = torch.randn(ci, co, 5, 5, device=dev, generator=g) / (co * 25) ** 0.5
    return x, wt, torch.randn(co, device=dev, generator=g)


# the kernel's f64 error over cuDNN f32's, at most: 3xTF32 loses ~2^-21 of
# each product where cuDNN's f32 dgrad sums a phase's short K (4-9 taps x
# C_in) at f32-FMA accuracy; measured on an H100 at the shapes below:
# 0.20-2.03 (above 1 at 10 of 40, the most at a pruned CC_GD's 37 -> 203;
# WACNN's at most 1.08)
DECONV_TOL = 2.5


def _deconv_lib(x, wt, b):
    import torch.nn.functional as F

    return F.conv_transpose2d(x, wt, b, stride=2, padding=2, output_padding=1)


@pytest.mark.parametrize("batch", [24, 1])
@pytest.mark.parametrize(
    "shape", _conv_shapes.routed_transposed()
    + _conv_shapes.routed_transposed(transposed=True), ids=str)
def test_deconv_tc_matches_f64_within_cudnn_f32(dev, shape, batch):
    """The kernel's four phases at every transposed convolution the models
    route to it (WACNN's synthesis, CC's hyper synthesis, a pruned CC_GD's
    odd widths; 512x768 and 768x512), at batch 24 and 1: its largest error
    against an f64 transposed convolution is at most DECONV_TOL x that of
    cuDNN's f32 one (TF32 off) at the same inputs; one launch a call, in
    the form `deconv_joint` picks; the packing is its plain version's."""
    from stf_tpu_torch.utils.numerics import use_numerical_policy

    use_numerical_policy()
    ci, co, h, w = shape
    x, wt, b = _deconv_inputs(dev, ci, co, h, w, batch)
    joint = conv_core.deconv_joint(co)
    key = conv_core.deconv_launch_key(joint)
    kernels = [conv_core.joint_kernel(wt)] if joint else conv_core.phase_kernels(wt)
    plain = torch.cat([conv_core.pack_weight_plain(k, round_small=True).reshape(-1)
                       for k in kernels])
    assert torch.equal(conv_core.deconv_pack_weight(wt), plain)
    before = _native.launch_counts[key]
    got = conv_core.conv_transpose2d_tc(x, wt, b)
    torch.cuda.synchronize()
    assert _native.launch_counts[key] == before + 1
    err = (got.double() - _deconv_lib(x.double(), wt.double(), b.double())
           ).abs().max().item()
    ref = (_deconv_lib(x, wt, b).double()
           - _deconv_lib(x.double(), wt.double(), b.double())).abs().max().item()
    print(f"{shape} batch {batch} joint {joint}: kernel {err:.3g}, "
          f"cuDNN f32 {ref:.3g}")
    assert err <= DECONV_TOL * ref, (err, ref)


@pytest.mark.parametrize("joint", [False, True], ids=["phases", "joint"])
@pytest.mark.parametrize("shape", [(320, 192, 32, 48), (192, 3, 64, 96),
                                   (61, 37, 8, 12), (29, 5, 19, 23)], ids=str)
def test_deconv_tc_is_bitwise_batch_and_configuration_invariant(dev, shape,
                                                                joint):
    """In either form, an image's outputs at batch 24 equal, bit for bit,
    its outputs alone and the batch's outputs under every tile
    configuration; both forms are within 4e-6 of the largest output of
    the plain decomposition (`conv_transpose2d_tc_plain`)."""
    from stf_tpu_torch.utils.numerics import use_numerical_policy

    use_numerical_policy()  # the plain version's F.conv2d without TF32
    ci, co, h, w = shape
    x, wt, b = _deconv_inputs(dev, ci, co, h, w, 24, seed=1)
    y = conv_core.conv_transpose2d_tc(x, wt, b, joint=joint)
    for i in range(x.shape[0]):
        assert torch.equal(conv_core.conv_transpose2d_tc(
            x[i:i + 1].clone(), wt, b, joint=joint), y[i:i + 1])
    for config in range(len(conv_core.CONFIGS)):
        assert torch.equal(conv_core.conv_transpose2d_tc(
            x, wt, b, config=config, joint=joint), y)
    plain = conv_core.conv_transpose2d_tc_plain(x[:2], wt, b, joint=joint)
    assert ((y[:2] - plain).abs().max().item()
            <= 4e-6 * plain.abs().max().item())


def test_deconv_tc_replays_in_a_graph_as_it_runs_eagerly(dev):
    """A captured launch, in either form, replayed on new inputs gives the
    eager launch's bits."""
    for ci, co in ((192, 192), (192, 3)):
        x, wt, b = _deconv_inputs(dev, ci, co, 32, 48, 4, seed=2)
        x2 = torch.randn_like(x)
        static = x.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            conv_core.conv_transpose2d_tc(static, wt, b)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = conv_core.conv_transpose2d_tc(static, wt, b)
        for inp in (x, x2):
            static.copy_(inp)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, conv_core.conv_transpose2d_tc(inp, wt, b))


def test_conv_transpose2d_routes_on_the_card(dev):
    """`ConvTranspose2d` (what `deconv` builds) launches the kernel for an
    f32 call in inference mode, keeping its weight's packing until the
    weight changes in place, and within 1e-5 of cuDNN; not under autograd
    (training), in bf16, at another geometry or with an `output_size`."""
    from stf_tpu_torch.layers import ConvTranspose2d, deconv

    layer = deconv(16, 8).to(dev)
    assert type(layer) is ConvTranspose2d
    x = torch.randn(2, 16, 10, 12, device=dev)
    keys = [conv_core.deconv_launch_key(j) for j in (False, True)]

    def launched(fn):
        before = [_native.launch_counts[k] for k in keys]
        out = fn()
        torch.cuda.synchronize()
        return out, sum(_native.launch_counts[k] for k in keys) - sum(before)

    with torch.inference_mode():
        got, n = launched(lambda: layer(x))
        assert n == 1 and got.shape == (2, 8, 20, 24)
        packs = _native.launch_counts["conv_tc_pack"]
        layer(x)
        assert _native.launch_counts["conv_tc_pack"] == packs
        assert torch.equal(got, conv_core.conv_transpose2d_tc(
            x, layer.weight, layer.bias))
    with torch.no_grad():
        layer.weight.mul_(2.0)
    with torch.inference_mode():
        _, n = launched(lambda: layer(x))
        assert n == 1 and _native.launch_counts["conv_tc_pack"] > packs
    with torch.no_grad():
        layer.weight.mul_(0.5)
    train, n = launched(lambda: layer(x))
    assert n == 0 and train.requires_grad
    assert (train.detach() - got).abs().max().item() <= 1e-5
    with torch.inference_mode():
        _, n = launched(lambda: layer(x, output_size=(20, 24)))
        assert n == 0
        _, n = launched(lambda: layer.to(torch.bfloat16)(x.bfloat16()))
        assert n == 0
        other = ConvTranspose2d(16, 8, 3, stride=2, padding=1,
                                output_padding=1).to(dev)
        _, n = launched(lambda: other(x))
        assert n == 0


def test_deconv_tc_rejects_bad_inputs(dev):
    """Other dtypes, non-contiguous operands, a packing of the other form
    and unknown configurations raise."""
    x, wt, b = _deconv_inputs(dev, 8, 16, 10, 12, 2)
    with pytest.raises(TypeError):
        conv_core.conv_transpose2d_tc(x.double(), wt.double(), b.double())
    with pytest.raises(ValueError):
        conv_core.conv_transpose2d_tc(x.transpose(2, 3), wt, b)
    with pytest.raises(ValueError):
        conv_core.conv_transpose2d_tc(x, wt[:, :, :3, :3], b)
    with pytest.raises(ValueError):
        conv_core.conv_transpose2d_tc(
            x, wt, b, joint=False,
            packed=conv_core.deconv_pack_weight(wt, joint=True))
    with pytest.raises(ValueError):
        conv_core.conv_transpose2d_tc(x, wt, b, config=len(conv_core.CONFIGS))


XHAT_GAP_WACNN = 2e-5  # the WACNN cells' `xhat_gap` limit (PERF.md section 2)


@pytest.mark.parametrize("batch", [24, 1])
@pytest.mark.parametrize("name", ["cnn", "cc"])
def test_round_trip_through_the_deconv_kernel(dev, monkeypatch, name, batch):
    """The full-width WACNN and CC at 128x192 through the lane codec (the
    full tier's compress and a replay; another codec's fused and per-slice
    decompress): the decoder gives the encoder's symbols, so CC's hyper
    synthesis, whose transposed convolutions run on the kernel on both
    sides, computed the same bits; its hyper outputs at batch 24 equal
    each image's alone; the kernel's phases launch in the decompress (and
    in CC's compress), none of cuDNN's; x_hat is within the WACNN cells'
    `xhat_gap` limit of a decode whose transposed convolutions take
    cuDNN (`routes_transposed` off)."""
    from stf_tpu_torch.models import Codec
    from stf_tpu_torch.zoo import create_model

    model = create_model(name, seed=0)
    x = np.concatenate([_pattern(128, 192, k) for k in range(12)])[:batch]
    enc_codec = Codec(model, coder="lane", device=dev, fused_encode=True)
    dec_codec = Codec(model, coder="lane", device=dev)

    def deconv_launches(before):
        return sum(v for k, v in _lane_launches(before).items()
                   if k.startswith("conv_tc_deconv"))

    enc_codec.compress(x)
    before = dict(_native.launch_counts)
    enc = enc_codec.compress(x)
    enc_launches = deconv_launches(before)
    before = dict(_native.launch_counts)
    fused = dec_codec.decompress(enc["strings"], enc["shape"])
    dec_launches = deconv_launches(before)
    dec_codec.fused = False
    walk = dec_codec.decompress(enc["strings"], enc["shape"])
    for s, f, w in zip(enc["symbols"], fused["symbols"], walk["symbols"]):
        assert torch.equal(f, s) and torch.equal(w, s)
    assert torch.equal(fused["x_hat"], walk["x_hat"])
    # fused decompress: the graph's first call runs the walk eagerly, then
    # captures it (module docstring), so its launches count twice
    assert dec_launches > 0 and (enc_launches > 0) == (name == "cc"), (
        enc_launches, dec_launches)
    if name == "cc":
        z_hat = torch.randn(batch, 192, 2, 3, device=dev).round()
        with torch.inference_mode():
            lm, ls = model.to(dev).hyper_synthesize(z_hat, (8, 12))
            for i in range(batch):
                one = model.hyper_synthesize(z_hat[i:i + 1], (8, 12))
                assert torch.equal(one[0], lm[i:i + 1])
                assert torch.equal(one[1], ls[i:i + 1])
    monkeypatch.setattr(conv_core, "routes_transposed",
                        lambda *a, **k: False)
    lib_codec = Codec(model, coder="lane", device=dev)
    lib_codec.fused = False
    lib = lib_codec.decompress(enc["strings"], enc["shape"])
    gap = (lib["x_hat"].float() - walk["x_hat"].float()).abs().max().item()
    print(f"{name} batch {batch}: deconv launches {enc_launches} / "
          f"{dec_launches}, x_hat gap to cuDNN {gap:.3g}")
    assert gap <= XHAT_GAP_WACNN, gap
