"""The TBC slice: the port's TransformerBasedCoding and Codec against the
JAX ones at the same (imported) weights, on the CPU, for a small TBC whose
attention geometries are the full model's (`_torch_port.TBC_SMALL`: 8x8
windows at head widths 4, 6, 8 and 10, the hyper stacks' 4x4 at 6) and
whose 40-channel y splits unevenly into 6 slices (7, 7, 7, 7, 7, 5).

Tolerances and exactness as `_torch_family` states them. At 72x72 the
analysis's stages are 36, 18, 9 and 5 wide (odd maps padded by
PatchMerging, every block's map padded to 8x8 windows). Planted faults in
the Swin stages each miss the forward tolerance by more than tenfold; a
fault-free rewrite of the same layer stays within it.
"""

import os
import re

import pytest
import torch
import torch.nn.functional as F

import _torch_family as fam
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import pair_from_port, port_small
import stf_tpu_torch
from stf_tpu_torch.layers import attention_core as ac
from stf_tpu_torch.layers import swin
from stf_tpu_torch.layers.win_attention import WindowAttention
from stf_tpu_torch.models.base import slice_widths
from stf_tpu_torch.zoo import create_model

SIZES = (64, 72)
WIDTHS = [7, 7, 7, 7, 7, 5]


@pytest.fixture(scope="module")
def pair():
    jmodel, params, port = pair_from_port(seed=5, name="tbc")
    return dict(jmodel=jmodel, params=params, port=port)


@pytest.fixture(scope="module")
def forwards(pair):
    """{size: (JAX eval forward, port eval forward)} on two images."""
    return {size: (fam.jax_forward(pair["jmodel"], pair["params"],
                                   fam.images(size)),
                   fam.port_forward(pair["port"], fam.images(size)))
            for size in SIZES}


@pytest.mark.parametrize("size", SIZES)
def test_eval_forward_matches_jax(forwards, size):
    want, got = forwards[size]
    fam.check_forward(got, want, size, y_ch=40, z_ch=24)


def test_eval_forward_depends_on_the_image(forwards):
    for size in SIZES:
        fam.check_depends_on_the_image(forwards[size][1])


def _compiled_instances():
    """B1's compiled (window, head width) pairs: the `STF_INSTANCES` table
    of csrc/window_attention.cu."""
    src = os.path.join(os.path.dirname(stf_tpu_torch.__file__), "csrc",
                       "window_attention.cu")
    with open(src) as f:
        return {(int(w), int(h)) for w, h in
                re.findall(r"^\s*X\((\d+), (\d+), \d+\)", f.read(), re.M)}


def _geometries(model):
    return {(m.window_size[0], m.dim // m.num_heads)
            for m in model.modules() if isinstance(m, WindowAttention)}


def test_attention_geometries_are_b1_instances():
    """The full-width TBC's attention runs at 8x8 windows with head widths
    4, 6, 8 and 10 and at 4x4 with 6, each a compiled B1 instance, and the
    small model's at the same geometries; B1 runs 30 times a compress
    (analysis 12, h_a 6, h_mean_s and h_scale_s 6 each) and 24 a
    decompress (the hyper synthesis's 12, the synthesis's 12)."""
    full = create_model("tbc")
    want = {(8, 4), (8, 6), (8, 8), (8, 10), (4, 6)}
    assert _geometries(full) == want <= _compiled_instances()
    assert ac.launch_key(8, 6) == "window_attention_ws8_hd6"
    assert _geometries(port_small(0, "tbc")) == want

    def blocks(stack):
        return sum(len(stage.blocks) for stage in stack)

    enc = sum(blocks(getattr(full, n)) for n in ("layers", "h_a", "h_mean_s",
                                                 "h_scale_s"))
    dec = sum(blocks(getattr(full, n)) for n in ("h_mean_s", "h_scale_s",
                                                 "syn_layers"))
    assert (enc, dec) == (30, 24)
    assert (full.M, full.N, full.analysis_downsample,
            full.hyper_upsample) == (320, 192, 16, 4)
    assert slice_widths(320, 10) == [32] * 10
    assert slice_widths(40, 6) == WIDTHS


# -- planted faults -----------------------------------------------------------

def _merge(order):
    """PatchMerging.forward gathering the 2x2 offsets in `order`."""
    def forward(self, x):
        _, H, W, _ = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, i::2, j::2] for i, j in order], dim=-1)
        return self.reduction(self.norm(x))
    return forward


def _split_transposed(self, x):
    """PatchSplit's depth-to-space in (i, j, c) channel order instead of
    PixelShuffle's (c, i, j)."""
    x = self.reduction(self.norm(x))
    B, H, W, C = x.shape
    x = x.reshape(B, H, W, 2, 2, C // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, 2 * H, 2 * W, C // 4)


def _patch(cls, forward):
    def patch(port):
        for m in port.modules():
            if isinstance(m, cls):
                m.forward = forward.__get__(m)
    return patch


def _no_shift(port):
    """Every shifted block runs unshifted (window partition and labels)."""
    for m in port.modules():
        if isinstance(m, swin.SwinTransformerBlock):
            m.shift_size = 0


FAULTS = {
    "faithful": _patch(swin.PatchMerging,
                       _merge([(0, 0), (1, 0), (0, 1), (1, 1)])),
    "merge_gather_swapped": _patch(swin.PatchMerging,
                                   _merge([(0, 0), (0, 1), (1, 0), (1, 1)])),
    "split_channels_transposed": _patch(swin.PatchSplit, _split_transposed),
    "no_shift": _no_shift,
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_eval_forward_comparison_catches_planted_faults(pair, forwards, fault):
    worst = fam.planted(pair["port"], FAULTS[fault], fam.images(72),
                        forwards[72][0])
    if fault == "faithful":
        assert worst <= fam.FORWARD_TOL, worst
    else:
        assert worst > 10 * fam.FORWARD_TOL, worst


# -- the codec ----------------------------------------------------------------

@pytest.fixture(scope="module")
def codecs(pair):
    return fam.codecs(pair["jmodel"], pair["params"], pair["port"])


def test_indexes_and_streams_match_jax(codecs):
    """Per slice, at the uneven widths 7, 7, 7, 7, 7 and 5."""
    fam.check_streams_match_jax(codecs, 6, WIDTHS)
    assert codecs["enc"]["symbols"][0].shape == (2, 4, 4, 7)


def test_cross_decoding(codecs):
    fam.check_cross_decoding(codecs)


def test_lane_and_host_round_trips_agree(codecs):
    fam.check_lane_and_host(codecs)


@pytest.mark.parametrize("tier", [True, "split"], ids=str)
def test_fused_encode_tiers_give_the_per_slice_stream(codecs, tier):
    fam.check_tier(codecs, tier)
