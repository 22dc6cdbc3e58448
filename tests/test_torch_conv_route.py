"""The route of the port's convolutions (`layers.conv.Conv2d`): which calls
launch the 3xTF32 kernel (`layers.conv_core`) and which take `F.conv2d`,
the kernel's arithmetic in its plain version against an f64 convolution,
its tile table, and the FLOP counters the codec's records keep by route.
CPU only and cheap; the kernel itself is held to these on the card in
`tests/test_torch_cuda.py`."""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu_torch.layers import conv_core
from stf_tpu_torch.utils import tracing

conv_mod = importlib.import_module("stf_tpu_torch.layers.conv")

CUDA = torch.device("cuda")


class _Tensor(SimpleNamespace):
    """What `routes` reads of a tensor, for a CUDA device on a CPU host."""

    def dim(self):
        return len(self.shape)


def _call(device=CUDA, dtype=torch.float32, k=3, stride=1, groups=1,
          padding=None, dilation=1, padding_mode="zeros", x_dim=4,
          bias_dtype=torch.float32):
    pad = k // 2 if padding is None else padding
    x = _Tensor(device=device, dtype=dtype, shape=(2, 8, 16, 16)[:x_dim])
    w = _Tensor(device=device, dtype=dtype, shape=(4, 8 // groups, k, k))
    b = None if bias_dtype is None else _Tensor(device=device,
                                                dtype=bias_dtype, shape=(4,))
    return (x, w, b, (stride, stride), (pad, pad), (dilation, dilation),
            groups, padding_mode)


ROUTES = {
    "f32_k3": (dict(), True),
    "f32_k1": (dict(k=1), True),
    "f32_k5": (dict(k=5), True),
    "no_bias": (dict(bias_dtype=None), True),
    "cpu": (dict(device=torch.device("cpu")), False),
    "bf16": (dict(dtype=torch.bfloat16, bias_dtype=torch.bfloat16), False),
    "f16": (dict(dtype=torch.float16, bias_dtype=torch.float16), False),
    "stride2": (dict(stride=2), False),
    "k7": (dict(k=7), False),
    "k2": (dict(k=2, padding=1), False),
    "groups2": (dict(groups=2), False),
    "padding0_k3": (dict(padding=0), False),
    "dilation2": (dict(dilation=2, padding=2), False),
    "reflect": (dict(padding_mode="reflect"), False),
    "x_3d": (dict(x_dim=3), False),
}


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("case", list(ROUTES))
def test_route_takes_the_kernel_only_for_f32_stride1_same_outside_autograd(
        case, grad):
    """The kernel takes f32 CUDA calls at stride 1, k in {1, 3, 5}, one
    group, zero padding k // 2, with grad mode off; everything else (CPU
    tensors, bf16 analysis convolutions, strided convolutions, every call
    that autograd records: training) takes F.conv2d."""
    kwargs, want = ROUTES[case]
    with torch.set_grad_enabled(grad):
        got = conv_core.routes(*_call(**kwargs))
    assert got == (want and not grad)


def test_conv2d_is_nn_conv2d_on_the_cpu():
    """`Conv2d` keeps nn.Conv2d's parameters and state_dict keys and, on
    CPU tensors with grad mode off (the codec's), computes F.conv2d; the
    helpers build it."""
    torch.manual_seed(0)
    ref = nn.Conv2d(6, 5, 3, padding=1)
    ours = conv_mod.Conv2d(6, 5, 3, padding=1)
    ours.load_state_dict(ref.state_dict())
    assert list(ours.state_dict()) == list(ref.state_dict())
    x = torch.randn(2, 6, 9, 7)
    with torch.inference_mode():
        assert not ours.launches(x)
        assert torch.equal(ours(x), ref(x))
    for made in (conv_mod.conv(3, 4), conv_mod.conv3x3(3, 4),
                 conv_mod.conv1x1(3, 4), conv_mod.subpel_conv3x3(3, 4, 2)[0]):
        assert type(made) is conv_mod.Conv2d


@pytest.mark.parametrize("k", [1, 3, 5])
def test_3xtf32_plain_is_f32_grade_and_one_tf32_pass_is_not(k):
    """The kernel's arithmetic (`conv2d_tc_plain`: TF32 big and small
    parts, three products summed in f32) against an f64 convolution:
    within 4x the error of an f32 F.conv2d at the same inputs, while a
    single TF32 pass (big * big alone) is at least 100x farther."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((2, 48, 12, 10))).float()
    w = torch.from_numpy(rng.standard_normal((20, 48, k, k)) / (48 * k * k) ** 0.5).float()
    b = torch.from_numpy(rng.standard_normal(20)).float()
    want = F.conv2d(x.double(), w.double(), b.double(), padding=k // 2)

    def err(y):
        return (y.double() - want).abs().max().item()

    f32 = err(F.conv2d(x, w, b, padding=k // 2))
    three = err(conv_core.conv2d_tc_plain(x, w, b))
    one = err(conv_core.conv2d_tc_plain(x, w, b, passes=1))
    assert three <= 4 * f32, (three, f32)
    assert one >= 100 * f32, (one, f32)


def test_split_tf32_parts_are_tf32_and_sum_near_the_value():
    """big has no bit below TF32's 10-bit mantissa and is the value rounded
    to nearest (ties away); small likewise, and big + small is within 2^-21
    of the value, relatively; with big truncated, within 2^-20."""
    x = torch.tensor([1.0, -1.0, 1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11),
                      3.14159265, -2.71828183e-3, 0.0, 1e-30])
    big, small = conv_core.split_tf32(x)
    for part in (big, small):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    assert big[2].item() == 1 + 2 ** -10 and big[3].item() == 1.0
    assert big[4].item() == -(1 + 2 ** -10)
    rel = ((big + small) - x).abs() / x.abs().clamp_min(1e-38)
    assert rel.max().item() <= 2 ** -21
    # truncated (the kernel's split of x): big drops the low bits
    big, small = conv_core.split_tf32(x, rounded=False)
    assert big[2].item() == 1.0 and big[4].item() == -1.0
    rel = ((big + small) - x).abs() / x.abs().clamp_min(1e-38)
    assert rel.max().item() <= 2 ** -20


@pytest.mark.parametrize("M,N", [(36864, 224), (36864, 176), (36864, 64),
                                 (1536, 224), (1536, 32), (2359296, 192),
                                 (9437184, 3), (1536, 16), (96, 1536)])
def test_tile_config_is_a_pure_function_of_the_gemm(M, N):
    """The table picks a configuration of `CONFIGS` from (M, N, split,
    SMs) alone, one of least modelled time: no configuration's waves x
    outputs a wave / rate is smaller."""
    got = conv_core.tile_config(M, N, 2, 132)
    assert got == conv_core.tile_config(M, N, 2, 132)
    assert 0 <= got < len(conv_core.CONFIGS) == len(conv_core._RATE)

    def cost(i):
        bm, bn, per_sm = conv_core.CONFIGS[i]
        blocks = -(-M // bm) * -(-N // bn) * 2
        return -(-blocks // (132 * per_sm)) * per_sm * bm * bn / conv_core._RATE[i]

    assert cost(got) == min(cost(i) for i in range(len(conv_core.CONFIGS)))
    if N <= 8 and M > 10 ** 6:
        assert conv_core.CONFIGS[got][1] == 8


@pytest.mark.parametrize("c_in,k,want", [(480, 3, 4), (224, 3, 2), (176, 3, 2),
                                         (128, 3, 1), (64, 3, 1), (192, 1, 1),
                                         (48, 5, 1), (256, 3, 3), (61, 3, 1),
                                         (608, 3, 4)])
def test_splits_follow_c_in_and_k_alone(c_in, k, want):
    """Split K: one block a run of at least 24 stages of 32 columns of
    k * k * Cp (Cp = C_in rounded up to 8), at most 4 blocks."""
    assert conv_core.padded_channels(c_in) % 8 == 0
    assert conv_core.splits(c_in, k) == want


def test_packed_weight_is_tap_major_and_zero_padded():
    """Column (tap, c) of the packing is weight[n, c, tap] as its TF32 big
    part and exact rest, zero for channels past C_in (up to C_in rounded
    to 8); a group of 8 columns holds 8 big parts, then 8 small ones,
    column j at 2 (j % 4) + j // 4 of its half."""
    w = torch.randn(2, 5, 3, 3, generator=torch.Generator().manual_seed(0))
    p = conv_core.pack_weight_plain(w).reshape(2, 9, 2, 8)  # (n, tap, part, slot)
    assert torch.equal(p[:, :, :, [5, 3, 7]], torch.zeros(2, 9, 2, 3))
    assert (p[:, :, 0].view(torch.int32) & 0x1FFF).eq(0).all()
    for n, c, i, j in ((0, 0, 0, 0), (1, 4, 2, 1), (0, 3, 1, 2), (1, 2, 0, 2)):
        big, small = p[n, 3 * i + j, :, 2 * (c % 4) + c // 4]
        assert big + small == w[n, c, i, j] and big != w[n, c, i, j]


def _record(monkeypatch, phase, body):
    """One recorded codec call of `phase` (a profiler's flag set by hand)
    whose body runs `body()`; returns its record."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    monkeypatch.setattr(tracing._profiler, "_is_profiler_enabled", True)

    class Codec:
        @tracing.traced(phase, "tail")
        def call(self, probe=None):
            body()
            return {"symbols": [torch.zeros(1)]}

    Codec().call()
    return tracing.calls()[-1]


def test_records_count_conv_flops_by_route_and_replays(monkeypatch):
    """A recorded call sums 2 M N K of its Conv2d calls: CPU calls under
    the library; a graph's capture keeps its calls' sums apart (not in the
    call that captures) and each replay adds them; outside a record and a
    capture nothing is counted."""
    layer = conv_mod.Conv2d(4, 6, 3, padding=1)
    x = torch.zeros(2, 4, 5, 7)
    flops = 2 * (2 * 6 * 5 * 7) * (4 * 9)
    with torch.inference_mode():
        layer(x)  # no record open: nothing to count into
        with tracing.capturing(tracing.FlopSums()) as captured:
            layer(x)
            tracing.count_conv(tracing.flop_counter(), True, 1000)
    assert (captured.conv_kernel_flops, captured.conv_library_flops) == (
        1000, flops)

    def body():
        with torch.inference_mode():
            layer(x)
            with tracing.capturing(tracing.FlopSums()):
                layer(x)  # a capture inside the call: not the call's
            tracing.replayed(captured)
            tracing.replayed(captured)

    rec = _record(monkeypatch, "decode", body)
    assert rec.conv_kernel_flops == 2000
    assert rec.conv_library_flops == flops + 2 * flops


# -- the transposed convolution's sub-pixel phases ---------------------------


def _deconv_call(device=CUDA, dtype=torch.float32, k=5, stride=2, padding=2,
                 output_padding=1, dilation=1, groups=1, padding_mode="zeros",
                 x_dim=4, bias_dtype=torch.float32):
    x = _Tensor(device=device, dtype=dtype, shape=(2, 8, 16, 16)[:x_dim])
    w = _Tensor(device=device, dtype=dtype, shape=(8, 4 // groups, k, k))
    b = None if bias_dtype is None else _Tensor(device=device,
                                                dtype=bias_dtype, shape=(4,))
    return (x, w, b, (stride, stride), (padding, padding),
            (output_padding, output_padding), (dilation, dilation), groups,
            padding_mode)


DECONV_ROUTES = {
    "f32_k5_s2": (dict(), True),
    "no_bias": (dict(bias_dtype=None), True),
    "cpu": (dict(device=torch.device("cpu")), False),
    "bf16": (dict(dtype=torch.bfloat16, bias_dtype=torch.bfloat16), False),
    "stride1": (dict(stride=1, output_padding=0), False),
    "k3": (dict(k=3, padding=1), False),
    "padding1": (dict(padding=1), False),
    "output_padding0": (dict(output_padding=0), False),
    "groups2": (dict(groups=2), False),
    "dilation2": (dict(dilation=2), False),
    "x_3d": (dict(x_dim=3), False),
}


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("case", list(DECONV_ROUTES))
def test_transposed_route_takes_the_kernel_only_for_the_2x_upsampler(case,
                                                                     grad):
    """The kernel's phases take f32 CUDA calls of a 5x5 weight at stride 2,
    padding 2, output padding 1, one group, with grad mode off; CPU
    tensors, bf16, other geometries and every call autograd records take
    F.conv_transpose2d."""
    kwargs, want = DECONV_ROUTES[case]
    with torch.set_grad_enabled(grad):
        got = conv_core.routes_transposed(*_deconv_call(**kwargs))
    assert got == (want and not grad)


def test_conv_transpose2d_is_nn_conv_transpose2d_on_the_cpu():
    """`ConvTranspose2d`, which `deconv` builds, keeps nn.ConvTranspose2d's
    parameters and state_dict keys and, on CPU tensors, computes
    F.conv_transpose2d, with an `output_size` too."""
    torch.manual_seed(0)
    ref = nn.ConvTranspose2d(6, 5, 5, stride=2, padding=2, output_padding=1)
    ours = conv_mod.deconv(6, 5)
    assert type(ours) is conv_mod.ConvTranspose2d
    assert {k: v.shape for k, v in ours.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    ours.load_state_dict(ref.state_dict())
    x = torch.randn(2, 6, 5, 7)
    with torch.inference_mode():
        assert not ours.launches(x)
        assert torch.equal(ours(x), ref(x))
        assert torch.equal(ours(x, output_size=(9, 13)),
                           ref(x, output_size=(9, 13)))


# (C_in, C_out) of WACNN's four synthesis layers, CC's hyper synthesis and
# a pruned CC_GD's odd widths
DECONV_WIDTHS = [(320, 192), (192, 192), (192, 3), (192, 256), (61, 37),
                 (29, 5), (45, 11)]


@pytest.mark.parametrize("joint", [False, True], ids=["phases", "joint"])
@pytest.mark.parametrize("c_in,c_out", DECONV_WIDTHS, ids=str)
def test_phase_decomposition_is_the_transposed_convolution(c_in, c_out,
                                                           joint):
    """The four sub-pixel phases (`conv_transpose2d_phases`: each phase's
    correlation written to its pixels, or the joint form's one correlation
    pixel-shuffled) equal F.conv_transpose2d (stride 2, padding 2, output
    padding 1) in f64 on a small map, at the models' widths."""
    rng = np.random.default_rng(c_in * 1000 + c_out)
    x = torch.from_numpy(rng.standard_normal((2, c_in, 3, 4)))
    w = torch.from_numpy(rng.standard_normal((c_in, c_out, 5, 5)))
    b = torch.from_numpy(rng.standard_normal(c_out))
    want = F.conv_transpose2d(x, w, b, stride=2, padding=2, output_padding=1)
    got = conv_core.conv_transpose2d_phases(x, w, b, joint=joint)
    assert got.shape == want.shape == (2, c_out, 6, 8)
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


def test_phases_use_each_tap_once_and_the_joint_form_zeros_the_rest():
    """The phases' kernels hold the 25 taps once each (9 + 6 + 6 + 4); the
    joint kernel holds them at the window's rows >= py and columns >= px of
    row 4 co + 2 py + px, zero elsewhere (11 zeros a (co, c_in) pair); its
    packing is `pack_weight_plain` of it, and the phases' packings follow
    one another in `deconv_pack_weight`'s order."""
    w = torch.arange(1, 2 * 3 * 25 + 1, dtype=torch.float32).reshape(2, 3, 5, 5)
    kernels = conv_core.phase_kernels(w)
    assert [k.shape[2] * k.shape[3] for k in kernels] == list(
        conv_core.PHASE_TAPS) == [9, 6, 6, 4]
    taps = torch.cat([k.reshape(-1) for k in kernels])
    assert torch.equal(taps.sort().values, w.reshape(-1).sort().values)
    # phase (0, 1), tap (0, 0): x at (h - 1, w), kernel tap (4, 3)
    assert kernels[1][2, 1, 0, 0] == w[1, 2, 4, 3]
    joint = conv_core.joint_kernel(w).reshape(3, 4, 2, 3, 3)
    assert int((joint == 0).sum()) == 11 * 3 * 2
    assert torch.equal(joint[:, 3, :, 1:, 1:], kernels[3].reshape(3, 2, 2, 2))


@pytest.mark.parametrize("c_out,want", [(3, True), (5, True), (11, True),
                                        (192, False), (256, False),
                                        (37, False), (203, False)])
def test_deconv_form_follows_c_out_alone(c_out, want):
    """The joint form (x gathered once, 4 C_out columns over all 9 taps)
    where C_out is small, WACNN's 3-channel output among them; one GEMM a
    phase over its own taps at the synthesis's widths: the cost model's
    choice, from C_out alone."""
    assert conv_core.deconv_joint(c_out) is want


@pytest.mark.parametrize("joint", [False, True], ids=["phases", "joint"])
def test_deconv_3xtf32_plain_is_f32_grade(joint):
    """The kernel's arithmetic on the phases (`conv_transpose2d_tc_plain`)
    against an f64 transposed convolution: within 4x the error of an f32
    F.conv_transpose2d at the same inputs; a single TF32 pass is at least
    100x farther."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 40, 6, 5))).float()
    w = torch.from_numpy(rng.standard_normal((40, 12, 5, 5)) / 120).float()
    b = torch.from_numpy(rng.standard_normal(12)).float()

    def err(y):
        want = F.conv_transpose2d(x.double(), w.double(), b.double(),
                                  stride=2, padding=2, output_padding=1)
        return (y.double() - want).abs().max().item()

    f32 = err(F.conv_transpose2d(x, w, b, stride=2, padding=2,
                                 output_padding=1))
    three = err(conv_core.conv_transpose2d_tc_plain(x, w, b, joint=joint))
    one = err(conv_core.conv_transpose2d_tc_plain(x, w, b, joint=joint,
                                                  passes=1))
    assert three <= 4 * f32, (three, f32)
    assert one >= 100 * f32, (one, f32)


def test_records_count_deconv_flops_by_route_and_replays(monkeypatch):
    """A recorded call sums 2 x input pixels x C_in x C_out x 25 of its
    ConvTranspose2d calls, apart from Conv2d's: CPU calls under the
    library; a graph's capture keeps its calls' sums and each replay adds
    them."""
    layer = conv_mod.deconv(4, 6)
    x = torch.zeros(2, 4, 5, 7)
    flops = 2 * (2 * 5 * 7) * 4 * 6 * 25
    with torch.inference_mode():
        layer(x)  # no record open: nothing to count into
        with tracing.capturing(tracing.FlopSums()) as captured:
            layer(x)
            tracing.count_deconv(tracing.flop_counter(), True, 1000)
    assert (captured.deconv_kernel_flops, captured.deconv_library_flops,
            captured.conv_library_flops) == (1000, flops, 0)

    def body():
        with torch.inference_mode():
            layer(x)
            tracing.replayed(captured)
            tracing.replayed(captured)

    rec = _record(monkeypatch, "decode", body)
    assert rec.deconv_kernel_flops == 2000
    assert rec.deconv_library_flops == flops + 2 * flops
    assert rec.conv_kernel_flops == rec.conv_library_flops == 0
