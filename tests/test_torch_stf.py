"""The STF slice as a whole: the port's SymmetricalTransFormer and Codec
against the JAX ones at the same (imported) weights, on the CPU, for a
small STF at the full model's window 4 and head width 16 (embed 16,
depths (1,1,2,1), heads (1,2,4,8), 4 slices).

The eval forward's floats must agree within atol 1e-4, x_hat and both
likelihoods (the frameworks' CPU matmuls and convolutions sum in
different orders, and flax's LayerNorm takes the variance as
E[x^2] - E[x]^2 where torch's subtracts the mean first: ~1e-6 per layer,
2e-6 at the end here). At 72x72 stage 2 is 9x9 (odd, padded to 12x12 in
its blocks) and stage 3 is 5x5 (padded to 8x8). Integers must match
exactly: symbols, scale indexes, z strings and the lane y-stream bytes of
the per-slice walk; at this seed no y - mu lies near enough to a
half-integer, nor any scale near enough to a table boundary, to flip.
Planted faults in the Swin layers each miss the forward tolerance by more
than tenfold.
"""

import copy
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import jax_walk_indexes, pair_from_port, smooth_images
from stf_tpu.models import Codec as JaxCodec
from stf_tpu_torch.layers import swin
from stf_tpu_torch.layers.win_attention import region_labels
from stf_tpu_torch.models import Codec

SIZES = (64, 72)


@pytest.fixture(scope="module")
def pair():
    jmodel, params, port = pair_from_port(seed=5, name="stf")
    return dict(jmodel=jmodel, params=params, port=port)


def _images(size):
    return smooth_images(2, size, size, seed=3).astype(np.float32) / 255.0


def _outputs(out):
    return {"x_hat": np.asarray(out["x_hat"]),
            **{k: np.asarray(v) for k, v in out["likelihoods"].items()}}


def _port_forward(port, x):
    with torch.no_grad():
        return _outputs(port(torch.from_numpy(x)))


@pytest.fixture(scope="module")
def forwards(pair):
    """{size: (JAX eval forward, port eval forward)} on two images."""
    apply = jax.jit(lambda params, x: pair["jmodel"].apply(
        {"params": params}, x, training=False))
    out = {}
    for size in SIZES:
        x = _images(size)
        out[size] = (_outputs(apply(pair["params"], jnp.asarray(x))),
                     _port_forward(pair["port"], x))
    return out


@pytest.mark.parametrize("size", SIZES)
def test_eval_forward_matches_jax(forwards, size):
    want, got = forwards[size]
    y = -(-size // 16)
    assert got["x_hat"].shape == (2, 16 * y, 16 * y, 3)
    assert got["y"].shape == (2, y, y, 128)
    for k in ("x_hat", "y", "z"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_eval_forward_depends_on_the_image(forwards):
    """Between the two images x_hat and the y likelihoods differ by far
    more than the tolerance, the z likelihoods by more than it."""
    for size in SIZES:
        got = forwards[size][1]
        for k, least in (("x_hat", 0.05), ("y", 0.5), ("z", 1e-4)):
            assert np.abs(got[k][0] - got[k][1]).max() > least, (size, k)


# -- planted faults -----------------------------------------------------------

def _edge_labels(H, W, Hp, Wp, ws, ss):
    """Shift-region labels of a padded Hp x Wp map with the regions cut at
    the unpadded H x W map's edge (the fault)."""
    img = np.zeros((Hp, Wp), np.int32)
    cuts = lambda n: (slice(0, n - ws), slice(n - ws, n - ss),  # noqa: E731
                      slice(n - ss, None))
    for k, (h, w) in enumerate((h, w) for h in cuts(H) for w in cuts(W)):
        img[h, w] = k
    img = img.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3)
    return torch.from_numpy(img.reshape(-1, ws * ws).copy())


def _block_forward(roll=True, padded_labels=True):
    """SwinTransformerBlock.forward, written out again with two switches:
    roll=False drops the cyclic shift of a shifted block (its labels
    stay), padded_labels=False cuts its shift regions at the unpadded
    edge. With both switches on it is the port's eval forward (DropPath
    is the identity there, and `sampler` unused)."""
    def forward(self, x, sampler=None):
        _, H, W, _ = x.shape
        ws, ss = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x)
        pb, pr = -H % ws, -W % ws
        x = F.pad(x, (0, 0, 0, pr, 0, pb))
        labels = None
        if ss:
            labels = (region_labels(H + pb, W + pr, ws, ss, x.device)
                      if padded_labels
                      else _edge_labels(H, W, H + pb, W + pr, ws, ss))
            if roll:
                x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
        x = self.attn(x, labels=labels)
        if ss and roll:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        x = shortcut + x[:, :H, :W, :]
        return x + self.mlp(self.norm2(x))
    return forward


def _merge_swapped(self, x):
    """PatchMerging with the (odd,even) and (even,odd) gathers swapped."""
    _, H, W, _ = x.shape
    x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 0::2], x[:, 1::2, 1::2]], dim=-1)
    return self.reduction(self.norm(x))


def _split_transposed(self, x):
    """PatchSplit's depth-to-space in (i, j, c) channel order instead of
    PixelShuffle's (c, i, j)."""
    x = self.reduction(self.norm(x))
    B, H, W, C = x.shape
    x = x.reshape(B, H, W, 2, 2, C // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, 2 * H, 2 * W, C // 4)


def _patch(port, cls, forward):
    for m in port.modules():
        if isinstance(m, cls):
            m.forward = types.MethodType(forward, m)


FAULTS = {
    "faithful": (swin.SwinTransformerBlock, _block_forward()),
    "no_roll": (swin.SwinTransformerBlock, _block_forward(roll=False)),
    "unpadded_labels": (swin.SwinTransformerBlock,
                        _block_forward(padded_labels=False)),
    "merge_gather_swapped": (swin.PatchMerging, _merge_swapped),
    "split_channels_transposed": (swin.PatchSplit, _split_transposed),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_eval_forward_comparison_catches_planted_faults(pair, forwards, fault):
    """At 72x72, where stage 2's shifted block pads 9x9 to 12x12, a copy of
    the port with one planted fault misses the JAX forward by more than
    ten times the 1e-4 tolerance; the fault-free rewrite of the block
    ("faithful") stays within it."""
    port = copy.deepcopy(pair["port"])
    _patch(port, *FAULTS[fault])
    got = _port_forward(port, _images(72))
    want = forwards[72][0]
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    if fault == "faithful":
        assert worst <= 1e-4, worst
    else:
        assert worst > 1e-3, worst


# -- the codec ----------------------------------------------------------------

@pytest.fixture(scope="module")
def codecs(pair):
    """The JAX per-slice lane codec and the port's lane codec (and its
    compress) on two 64x64 images."""
    x = smooth_images(2, 64, 64, seed=3)
    jcodec = JaxCodec(pair["jmodel"], pair["params"], coder="lane")
    jcodec.fused = False
    lane = Codec(pair["port"], coder="lane", device="cpu")
    return dict(x=x, jcodec=jcodec, jenc=jcodec.compress(x), lane=lane,
                enc=lane.compress(x))


def test_indexes_and_streams_match_jax(codecs):
    enc, jenc = codecs["enc"], codecs["jenc"]
    walk = jax_walk_indexes(codecs["jcodec"], codecs["x"])
    assert len(walk) == len(enc["indexes"]) == 4
    for (q, idx), s, i in zip(walk, enc["symbols"], enc["indexes"]):
        np.testing.assert_array_equal(i, idx.astype(np.int32))
        np.testing.assert_array_equal(s, q)
    assert max(int(i.max()) for i in enc["indexes"]) > 0
    assert enc["strings"][1] == jenc["strings"][1]  # z strings
    assert enc["strings"][0][0] == jenc["strings"][0][0]  # lane y-stream
    assert tuple(enc["shape"]) == tuple(jenc["shape"])


def test_cross_decoding(codecs):
    """Each package decodes the other's lane stream."""
    lane, jcodec, enc, jenc = (
        codecs[k] for k in ("lane", "jcodec", "enc", "jenc")
    )
    ours = lane.decompress(jenc["strings"], jenc["shape"])
    theirs = jcodec.decompress(enc["strings"], enc["shape"])
    for s, d in zip(enc["symbols"], ours["symbols"]):
        np.testing.assert_array_equal(d.numpy(), s)
    np.testing.assert_allclose(
        ours["x_hat"].numpy(), np.asarray(theirs["x_hat"]), atol=1e-4
    )


def test_lane_and_host_round_trips_agree(pair, codecs):
    """Fused and per-slice lane decompress and the host coder's round trip
    give the same symbols and bit-equal x_hat."""
    lane, enc = codecs["lane"], codecs["enc"]
    fused = lane.decompress(enc["strings"], enc["shape"])
    lane.fused = False
    try:
        walk = lane.decompress(enc["strings"], enc["shape"])
    finally:
        lane.fused = True
    host = Codec(pair["port"], coder="host", device="cpu")
    henc = host.compress(codecs["x"])
    hdec = host.decompress(henc["strings"], henc["shape"])
    assert henc["strings"][1] == enc["strings"][1]
    for s, h, f, w, hd in zip(enc["symbols"], henc["symbols"],
                              fused["symbols"], walk["symbols"],
                              hdec["symbols"]):
        for got in (h, f, w, hd):
            assert torch.equal(got, s)
    assert torch.equal(fused["x_hat"], walk["x_hat"])
    assert torch.equal(hdec["x_hat"], fused["x_hat"])
    assert fused["x_hat"].shape == (2, 64, 64, 3)


@pytest.mark.parametrize("tier", [True, "split"], ids=str)
def test_fused_encode_tiers_give_the_per_slice_stream(pair, codecs, tier):
    """Both tiers, run eagerly on the CPU, give the per-slice stream from
    byte 1 on with the fused-encode flag, and keep their tier (their
    self-check's decode passes; warnings are errors)."""
    codec = Codec(pair["port"], coder="lane", device="cpu", fused_encode=tier)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = codec.compress(codecs["x"])
    want = codecs["enc"]["strings"]
    assert got["strings"][0][0][0] == want[0][0][0] | 1
    assert got["strings"][0][0][1:] == want[0][0][1:]
    assert got["strings"][1] == want[1]
    assert codec.fused_encode
    assert codec._fused_mode == ("full" if tier is True else "split")
