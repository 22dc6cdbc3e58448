"""The bf16 codec (`Codec(dtype=torch.bfloat16)`) against the JAX codec's
`Codec(dtype=jnp.bfloat16)` at the same weights, on the CPU, for the small
WACNN of tests/test_lane_codec.py, the small STF of
tests/test_torch_stf.py and the small TBC and DYSTF of
`_torch_port.CONFIGS` (the families whose analysis runs B1 in bf16); and
kernel B1's bf16 plain version against the JAX bf16 attention core, at
every compiled (window, head width).

What the JAX bf16 codec computes: it casts every parameter but the
entropy bottleneck's to bf16, and the image to bf16. Flax promotes each
layer to the wider of its input's and its parameters' dtypes, so only
the analysis (g_a, h_a) computes in bf16; z_hat (`_z_quantize_math`
casts z to f32), the hyper synthesis, the walk and the synthesis compute
in f32 on the bf16-rounded weights. `test_dtype_flow_matches_jax` holds
the port to that. GDN's reparametrisation runs in the parameters' bf16
before it meets an f32 activation, and flax's LayerNorm takes its
statistics in f32 and rounds once; both are checked here at the bit.

Tolerances:
  * B1's bf16 plain version against the JAX core (the flax module, whose
    packed windows sum in another order) and against the Pallas kernel
    in interpret mode: at most one bf16 ulp an element, the ulp taken at
    the element's magnitude but not below 2^-12 of the largest output.
    Below that an output is the cancellation of much larger P * v terms,
    and f32 summation order alone moves it by more than its own ulp (seen
    at hd 16 on another draw: 1.937e-6 against the Pallas kernel's
    1.907e-6, 2 ulps apart). The counts of differing elements and of
    elements more than one ulp of their own apart are printed;
  * the analysis: the frameworks round a bf16 layer at other points
    (XLA rounds a convolution and then its bias add, torch once), and
    through the layers those ulps grow; the port's bf16 y and z must lie
    no farther from the JAX bf16 codec's than the JAX bf16 codec's lie
    from its own f32 analysis (the size of bf16 rounding through these
    layers). The differing share is printed;
  * integers: given the JAX bf16 codec's own y and z, every integer the
    port writes is the JAX codec's (z strings, scale indexes, symbols,
    the lane y-stream and the host y-streams, byte for byte). At these
    seeds no y - mu lies within f32 noise of a .5 boundary: none ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from _bf16 import ulp_errors as _ulp_errors
from _bf16 import ulps as _ulps
from _torch_port import jax_walk_indexes, pair_from_port, smooth_images
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu.layers.gdn import GDN as JaxGDN
from stf_tpu.layers.pallas_attention import pallas_window_attention
from stf_tpu.layers.win_attention import WindowAttention as JaxWindowAttention
from stf_tpu.layers.win_attention import shifted_window_region_labels
from stf_tpu.models import Codec as JaxCodec
from stf_tpu_torch.layers import GDN, relative_position_index
from stf_tpu_torch.layers import attention_core as ac
from stf_tpu_torch.models import Codec
from stf_tpu_torch.models.codec import _z_quantize_math

BF16 = torch.bfloat16


def _torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of its dtype (bf16 or f32)."""
    out = torch.from_numpy(np.asarray(a.astype(jnp.float32)))
    return out.to(BF16) if a.dtype == jnp.bfloat16 else out


def _bf16_from_jax(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(BF16)


# -- B1 in bf16 ---------------------------------------------------------------

@pytest.mark.parametrize("ws,hd", [(8, 24), (4, 40), (4, 16), (8, 4), (8, 6),
                                   (8, 8), (8, 10), (4, 6)])
def test_b1_bf16_plain_matches_the_jax_core(ws, hd):
    """The flax WindowAttention in bf16 (shifted, 8 heads): its qkv
    projection's output and its core's output (the input of `proj`) are
    read through an interceptor, and the port's plain version of B1 on
    that qkv and the same bf16 bias table must give the core's output
    within one ulp. The Pallas kernel does not trace with bf16 operands
    in this JAX (its f32 dot cannot be stored to a bf16 output ref), so
    it runs on the same bf16 values in f32, as its bf16 instance would
    compute them: q*scale rounded to bf16 beforehand (scale 1 inside),
    the output rounded to bf16 after."""
    nh, C = 8, 8 * hd
    H, W = 2 * ws, 2 * ws
    rng = np.random.default_rng(ws + hd)
    x = jnp.asarray(rng.normal(size=(1, H, W, C)), jnp.bfloat16)
    p = {
        "qkv": {"kernel": rng.normal(0, C ** -0.5, (C, 3 * C)),
                "bias": rng.normal(0, 0.1, 3 * C)},
        "proj": {"kernel": rng.normal(0, C ** -0.5, (C, C)),
                 "bias": rng.normal(0, 0.1, C)},
        "relative_position_bias_table": rng.normal(size=((2 * ws - 1) ** 2, nh)),
    }
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    labels = shifted_window_region_labels(H, W, ws, ws // 2)
    jm = JaxWindowAttention(dim=C, window_size=(ws, ws), num_heads=nh)

    @jax.jit
    def run(p, x):
        seen = {}

        def grab(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.method_name == "__call__":
                if context.module.name == "qkv":
                    seen["qkv"] = out
                elif context.module.name == "proj":
                    seen["core"] = args[0]
            return out

        with nn.intercept_methods(grab):
            jm.apply({"params": p}, x, labels=labels)
        return seen

    seen = run(p, x)
    assert seen["qkv"].dtype == seen["core"].dtype == jnp.bfloat16
    qkv = _bf16_from_jax(seen["qkv"])
    table = _bf16_from_jax(p["relative_position_bias_table"])
    idx = torch.from_numpy(relative_position_index(ws, ws).reshape(-1))
    bias = table[idx].reshape(ws * ws, ws * ws, nh).permute(2, 0, 1).contiguous()
    lab = torch.from_numpy(labels)
    scale = hd ** -0.5
    got = ac.window_attention(qkv, bias, lab, ws, scale)
    assert got.dtype == BF16
    jax_core = _bf16_from_jax(seen["core"])

    q, k, v = ac.partition_qkv(qkv, ws, nh)
    qs = (q * ac.bf16_scale(scale)).float()
    pair = np.where(labels[:, None, :] != labels[:, :, None], -100.0, 0.0)
    mask = jnp.asarray(pair.astype(np.float32))
    pallas = pallas_window_attention(
        *(jnp.asarray(t.float().numpy()) for t in (qs, k, v, bias)),
        mask, 1.0, interpret=True,
    )
    pallas = ac.unpartition(torch.from_numpy(np.asarray(pallas)), 1, H, W, ws)
    for what, want in (("the JAX core", jax_core),
                       ("the Pallas kernel", pallas.to(BF16))):
        ulps = _ulps(got, want)
        print(f"B1 bf16 ws{ws} hd{hd}: {int((ulps > 0).sum())} of "
              f"{ulps.numel()} elements differ from {what}, "
              f"{int((ulps > 1).sum())} by more than their own ulp")
        assert _ulp_errors(got, want).max().item() <= 1.0


def test_b1_bf16_takes_no_gradient():
    qkv = torch.randn(1, 4, 4, 3 * 16).to(BF16).requires_grad_()
    bias = torch.randn(1, 16, 16).to(BF16)
    with pytest.raises(NotImplementedError, match="bf16"):
        ac.window_attention(qkv, bias, None, 4, 0.25)
    with torch.no_grad():
        assert ac.window_attention(qkv, bias, None, 4, 0.25).dtype == BF16


# -- layers whose parameters are transformed before use -------------------------

@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_reparametrises_in_bf16(inverse):
    """GDN's beta and gamma from bf16 parameters, bit for bit as flax's
    (lower bound, square and pedestal in bf16), on a bf16 input (g_a) and
    on an f32 input (the f32 synthesis's inverse GDN, where the bf16
    reparametrised values are promoted): the bf16 outputs within two ulps
    (XLA rounds the 1x1 product and then the beta add, torch's
    convolution adds beta before its one rounding), the f32 outputs
    within f32 rounding."""
    C = 16
    rng = np.random.default_rng(7)
    beta = np.sqrt(rng.uniform(0.5, 2.0, C) + 2.0 ** -36)
    gamma = np.sqrt(np.abs(rng.normal(0, 0.1, (C, C))) + 2.0 ** -36)
    gamma[0, 1] = 2.0 ** -19  # below the lower bound
    jp = {"beta": jnp.asarray(beta, jnp.bfloat16),
          "gamma": jnp.asarray(gamma, jnp.bfloat16)}
    port = GDN(C, inverse=inverse)
    port.beta.data = torch.from_numpy(beta).to(BF16)
    port.gamma.data = torch.from_numpy(gamma).to(BF16)
    jg = JaxGDN(C, inverse=inverse)
    for dtype, jdtype in ((BF16, jnp.bfloat16), (torch.float32, jnp.float32)):
        x = rng.normal(size=(2, 4, 4, C)).astype(np.float32)
        want = jg.apply({"params": jp}, jnp.asarray(x, jdtype))
        with torch.no_grad():
            got = port(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))
        got = got.permute(0, 2, 3, 1)
        assert got.dtype == dtype and want.dtype == jdtype
        if dtype == BF16:
            assert int(_ulps(got, _bf16_from_jax(want)).max()) <= 2
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-6, atol=1e-7)
    beta_bf16 = port.beta_reparam(port.beta)
    want = jg.apply({"params": jp}, method=lambda m: m.beta_reparam(m.beta))
    assert beta_bf16.dtype == BF16
    assert torch.equal(beta_bf16, _bf16_from_jax(want))
    gamma_bf16 = port.gamma_reparam(port.gamma)
    want = jg.apply({"params": jp}, method=lambda m: m.gamma_reparam(m.gamma))
    assert torch.equal(gamma_bf16, _bf16_from_jax(want))
    assert gamma_bf16[0, 1] == 0  # bound 2^-18, squared less the pedestal


def test_layer_norm_rounds_once_as_flax():
    """F.layer_norm on a bf16 input with bf16 weights gives flax's
    LayerNorm (statistics in f32, one rounding at the end) to the bit,
    up to the frameworks' f32 variance forms: at most one ulp."""
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, size=(64, 48)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, 48).astype(np.float32)
    want = nn.LayerNorm(epsilon=1e-5).apply(
        {"params": {"scale": jnp.asarray(w, jnp.bfloat16),
                    "bias": jnp.asarray(b, jnp.bfloat16)}},
        jnp.asarray(x, jnp.bfloat16),
    )
    assert want.dtype == jnp.bfloat16
    got = F.layer_norm(torch.from_numpy(x).to(BF16), (48,),
                       torch.from_numpy(w).to(BF16),
                       torch.from_numpy(b).to(BF16), 1e-5)
    d = _ulps(got, _bf16_from_jax(want))
    print(f"LayerNorm bf16: {int((d > 0).sum())} of {d.numel()} differ by an ulp")
    assert int(d.max()) <= 1


# -- the codec ------------------------------------------------------------------

# each family's weight seed: one at which no y - mu of the JAX bf16 codec's
# y and z lies within 1e-5 of a .5 boundary (`test_integers_match_jax_...`
# needs none; DYSTF's at seed 11 has one)
SEEDS = {"cnn": 11, "stf": 11, "tbc": 11, "dystf": 13}


@pytest.fixture(scope="module", params=["cnn", "stf", "tbc", "dystf"])
def bf16(request):
    """The JAX bf16 lane codec (per-slice walk) and its compress of two
    64x64 images, the f32 analysis (the port's, within 1e-4 of JAX's:
    tests/test_torch_codec.py, tests/test_torch_stf.py), and the port's
    bf16 lane codec."""
    name = request.param
    jmodel, params, port = pair_from_port(seed=SEEDS[name], name=name)
    x = smooth_images(2, 64, 64, seed=3)
    jcodec = JaxCodec(jmodel, params, coder="lane", dtype=jnp.bfloat16)
    jcodec.fused = False
    jx = jnp.asarray(x)
    y, z = jcodec._analyze(jcodec.params, jx)
    with torch.inference_mode():
        yz32 = port.analyze(Codec._normalize(torch.from_numpy(x)))
    lane = Codec(port, coder="lane", device="cpu", dtype=BF16)
    return dict(name=name, jmodel=jmodel, params=params, port=port, x=x,
                jcodec=jcodec, jenc=jcodec.compress(x), lane=lane,
                jax_yz=(y, z), yz32=yz32)


def _nchw(a) -> torch.Tensor:
    return _torch(a).permute(0, 3, 1, 2).contiguous()


def _fed(codec, y, z):
    """`codec` with its analysis replaced by the JAX codec's y and z."""
    codec._analyze = lambda x: (_nchw(y), _nchw(z))
    return codec


def test_callers_model_stays_f32(bf16):
    port = bf16["port"]
    assert all(p.dtype == torch.float32 for p in port.parameters())
    lane = bf16["lane"]
    assert lane.model is not port
    eb = dict(lane.model.entropy_bottleneck.named_parameters())
    for k, p in port.entropy_bottleneck.named_parameters():
        assert torch.equal(eb[k], p)  # not rounded
    gdn_or_f32 = {p.dtype for n, p in lane.model.named_parameters()}
    assert gdn_or_f32 <= {torch.float32, BF16}
    assert {p.dtype for n, p in lane._analysis_model.named_parameters()
            if not n.startswith("entropy_bottleneck.")} == {BF16}


def test_dtype_flow_matches_jax(bf16):
    """bf16 y and z; f32 z_hat, lm, ls, mu, y_hat and x_hat, in both."""
    jc, lane, x = bf16["jcodec"], bf16["lane"], bf16["x"]
    y, z = bf16["jax_yz"]
    *_, z_hat = jc._z_quantize(z, jnp.asarray(jc.eb_coder.medians))
    lm, ls = jc._hyper(jc.params, z_hat, (y.shape[1], y.shape[2]))
    mu, _ = jc._slice_idx(jc.params, 0, lm, ls, ())
    q = jnp.round(jnp.split(y, jc.model.slice_boundaries(y.shape[-1]),
                            axis=-1)[0] - mu).astype(jnp.int32)
    y_hat = jc._slice_apply(jc.params, 0, lm, (), mu, q)
    # the synthesis's dtype from its traced shapes, without compiling it
    x_hat = jax.eval_shape(jc._synth, jc.params, jax.ShapeDtypeStruct(
        y.shape, y_hat.dtype))
    want = {"y": y.dtype, "z": z.dtype, "z_hat": z_hat.dtype, "lm": lm.dtype,
            "ls": ls.dtype, "mu": mu.dtype, "y_hat": y_hat.dtype,
            "x_hat": x_hat.dtype}

    model, got = lane.model, {}
    with torch.inference_mode():
        y, z = lane._analyze(lane._normalize(torch.from_numpy(x)))
        _, z_hat = _z_quantize_math(z, lane._medians)
        lm, ls = model.hyper_synthesize(z_hat, y.shape[2:])
        mu, _ = model.decode_slice_indexes(0, lm, ls, (), lane._table)
        q = torch.round(model.split_slices(y)[0] - mu).to(torch.int32)
        y_hat = model.decode_slice_apply(0, lm, (), mu, q)
        x_hat = lane._synthesize([[y.float()]])
    for k, t in (("y", y), ("z", z), ("z_hat", z_hat), ("lm", lm), ("ls", ls),
                 ("mu", mu), ("y_hat", y_hat), ("x_hat", x_hat)):
        got[k] = t.dtype
    names = {"bfloat16": BF16, "float32": torch.float32}
    assert got == {k: names[str(v)] for k, v in want.items()}
    assert got["y"] == got["z"] == BF16 and got["x_hat"] == torch.float32


# the band of the bf16 analysis, in multiples of the JAX bf16 analysis's
# own distance from its f32 one (max and mean): 1 for WACNN's and STF's;
# 2 for TBC's 18 transformer blocks before z (the port's bf16 z, 48 values
# at this size, lies 1.5x as far from its f32 z as JAX's does) and for
# DYSTF, whose bf16 scores flip kept tokens between the packages as
# between bf16 and f32 (measured: tbc z 0.156 against a band of 0.094,
# mean 0.041 against 0.021; dystf y 7.53 against 7.33)
BAND = {"cnn": 1, "stf": 1, "tbc": 2, "dystf": 2}


def test_analysis_matches_jax_within_bf16_noise(bf16):
    """The port's bf16 g_a and h_a (with B1 in bf16) against the JAX bf16
    codec's at the same weights and image, within BAND times the JAX bf16
    analysis's own distance from the f32 one (for a band of 2, the mean
    distance too)."""
    lane, x = bf16["lane"], bf16["x"]
    with torch.inference_mode():
        y, z = lane._analyze(lane._normalize(torch.from_numpy(x)))
    for name, got, want, f32 in zip(("y", "z"), (y, z), bf16["jax_yz"],
                                    bf16["yz32"]):
        want = _nchw(want).float()
        err = (got.float() - want).abs()
        noise = (want - f32).abs().max().item()
        mean_noise = (want - f32).abs().mean().item()
        print(f"{bf16['name']} bf16 {name}: port vs JAX max {err.max():.4g}, "
              f"mean {err.mean():.4g}; {100 * (err > 0).float().mean():.1f}% "
              f"of elements differ; JAX bf16 vs f32 max {noise:.4g}, mean "
              f"{mean_noise:.4g} (largest |{name}| {want.abs().max():.4g})")
        band = BAND[bf16["name"]]
        assert err.max().item() <= band * noise
        if band > 1:
            assert err.mean().item() <= band * mean_noise


def test_integers_match_jax_given_its_y_and_z(bf16):
    """The port's bf16 walk on the JAX bf16 codec's own y and z writes
    the JAX codec's z strings, scale indexes, symbols and lane y-stream,
    and the port's host coder its host y-streams, byte for byte."""
    y, z = bf16["jax_yz"]
    lane = _fed(bf16["lane"], y, z)
    x, jc, jenc = bf16["x"], bf16["jcodec"], bf16["jenc"]
    try:
        enc = lane.compress(x)
    finally:
        del lane._analyze
    # the port's own y - mu on these y and z: how many lie within 1e-5 of
    # a .5 boundary, where an f32 difference in mu could flip a symbol
    residuals = []
    with torch.inference_mode():
        y_t, z_t = _nchw(y), _nchw(z)
        _, z_hat = _z_quantize_math(z_t, lane._medians)
        lm, ls = lane.model.hyper_synthesize(z_hat, y_t.shape[2:])
        slices = lane.model.split_slices(y_t)

        def keep(i, mu, idx):
            residuals.append((slices[i] - mu).flatten())
            return torch.round(slices[i] - mu).to(torch.int32)

        lane._walk_slices(lm, ls, keep, need_y_hat=False)
    r = torch.cat(residuals)
    ties = int(((r - torch.floor(r) - 0.5).abs() < 1e-5).sum())
    print(f"{bf16['name']} bf16: {ties} of {r.numel()} y - mu within 1e-5 "
          "of a .5 boundary")
    assert ties == 0
    walk = jax_walk_indexes(jc, x)
    for (q, idx), s, i in zip(walk, enc["symbols"], enc["indexes"]):
        np.testing.assert_array_equal(i, idx.astype(np.int32))
        np.testing.assert_array_equal(s, q)
    assert enc["strings"][1] == jenc["strings"][1]
    assert enc["strings"][0][0] == jenc["strings"][0][0]

    jhost = JaxCodec(bf16["jmodel"], bf16["params"], coder="host",
                     dtype=jnp.bfloat16)
    # the JAX host codec's own analysis: the same jitted program as the
    # lane codec's, so the same y and z
    jhenc = jhost.compress(x)
    host = _fed(Codec(bf16["port"], coder="host", device="cpu", dtype=BF16),
                y, z)
    henc = host.compress(x)
    assert henc["strings"] == jhenc["strings"]


def test_bf16_codec_is_self_consistent(bf16):
    """On the port's own bf16 analysis: decoded symbols equal the encoded
    ones, host and lane x_hat are bit-equal, fused and per-slice
    decompress are bit-equal, and both fused encode tiers (eager on the
    CPU) give the per-slice stream from byte 1 on."""
    lane, x, port = bf16["lane"], bf16["x"], bf16["port"]
    enc = lane.compress(x)
    fused = lane.decompress(enc["strings"], enc["shape"])
    lane.fused = False
    try:
        walk = lane.decompress(enc["strings"], enc["shape"])
    finally:
        lane.fused = True
    host = Codec(port, coder="host", device="cpu", dtype=BF16)
    henc = host.compress(x)
    hdec = host.decompress(henc["strings"], henc["shape"])
    for s, f, w, h in zip(enc["symbols"], fused["symbols"], walk["symbols"],
                          hdec["symbols"]):
        assert torch.equal(f, s) and torch.equal(w, s) and torch.equal(h, s)
    assert torch.equal(fused["x_hat"], walk["x_hat"])
    assert torch.equal(hdec["x_hat"], fused["x_hat"])
    for tier in (True, "split"):
        codec = Codec(port, coder="lane", device="cpu", dtype=BF16,
                      fused_encode=tier)
        got = codec.compress(x)["strings"]
        assert got[0][0][0] == enc["strings"][0][0][0] | 1
        assert got[0][0][1:] == enc["strings"][0][0][1:]
        assert got[1] == enc["strings"][1]
        assert codec.fused_encode and codec._fused_mode == (
            "full" if tier is True else "split")
