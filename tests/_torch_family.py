"""Checks shared by the model-family parity tests (tests/test_torch_tbc.py,
tests/test_torch_cc.py, tests/test_torch_dystf.py): a small JAX model and
the port's at the same weights, the eval forward and the codec paths.

Floats: the eval forward's x_hat and likelihoods within atol 1e-4 (the
frameworks' CPU matmuls and convolutions sum in other orders). Integers
exactly: symbols, scale indexes, z strings and the lane y-stream of the
per-slice walk, against the JAX per-slice lane codec."""

import copy
import warnings

import jax
import numpy as np
import torch

from _torch_port import jax_walk_indexes, smooth_images
from stf_tpu.models import Codec as JaxCodec
from stf_tpu_torch.models import Codec

FORWARD_TOL = 1e-4


def images(size: int, n: int = 2, seed: int = 3) -> np.ndarray:
    """n smooth size x size float images in [0, 1]."""
    return smooth_images(n, size, size, seed=seed).astype(np.float32) / 255.0


def outputs(out) -> dict:
    return {"x_hat": np.asarray(out["x_hat"]),
            **{k: np.asarray(v) for k, v in out["likelihoods"].items()}}


def port_forward(port, x) -> dict:
    with torch.no_grad():
        return outputs(port(torch.from_numpy(x)))


_APPLY = {}


def jax_apply(jmodel):
    """The jitted eval forward of the flax model `jmodel`, one a model."""
    if id(jmodel) not in _APPLY:
        _APPLY[id(jmodel)] = jmodel, jax.jit(
            lambda p, v: jmodel.apply({"params": p}, v, training=False))
    return _APPLY[id(jmodel)][1]


def jax_forward(jmodel, params, x) -> dict:
    return outputs(jax_apply(jmodel)(params, x))


def worst(got: dict, want: dict) -> float:
    """The largest absolute difference over every output."""
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def check_forward(got: dict, want: dict, size: int, y_ch: int, z_ch: int):
    """Shapes of a size x size batch of two, then every output within
    FORWARD_TOL of JAX's."""
    y, z = -(-size // 16), -(-size // 64)
    assert got["x_hat"].shape[:3] == (2, 16 * y, 16 * y)
    assert got["y"].shape == (2, y, y, y_ch)
    assert got["z"].shape == (2, z, z, z_ch)
    for k in ("x_hat", "y", "z"):
        np.testing.assert_allclose(got[k], want[k], atol=FORWARD_TOL,
                                   err_msg=k)


def check_depends_on_the_image(got: dict):
    """x_hat and the y likelihoods differ between the two images by far
    more than the tolerance."""
    for k, least in (("x_hat", 0.05), ("y", 0.5)):
        assert np.abs(got[k][0] - got[k][1]).max() > least, k


def planted(port, patch, x, want) -> float:
    """`worst` of a copy of `port` with `patch(copy)` applied, on x."""
    port = copy.deepcopy(port)
    patch(port)
    return worst(port_forward(port, x), want)


def codecs(jmodel, params, port, size: int = 64) -> dict:
    """The JAX per-slice lane codec and the port's lane codec, each with
    its compress of two smooth size x size images."""
    x = smooth_images(2, size, size, seed=3)
    jcodec = JaxCodec(jmodel, params, coder="lane")
    jcodec.fused = False
    lane = Codec(port, coder="lane", device="cpu")
    return dict(x=x, jcodec=jcodec, jenc=jcodec.compress(x), lane=lane,
                enc=lane.compress(x), port=port)


def check_streams_match_jax(c: dict, num_slices: int, widths=None):
    """Scale indexes and symbols slice by slice (at each slice's own width
    when `widths` is given), z strings and the lane y-stream equal the JAX
    codec's."""
    enc, jenc = c["enc"], c["jenc"]
    walk = jax_walk_indexes(c["jcodec"], c["x"])
    assert len(walk) == len(enc["indexes"]) == num_slices
    for j, ((q, idx), s, i) in enumerate(zip(walk, enc["symbols"],
                                             enc["indexes"])):
        if widths is not None:
            assert s.shape[-1] == widths[j]
        np.testing.assert_array_equal(i, idx.astype(np.int32))
        np.testing.assert_array_equal(s, q)
    assert max(int(i.max()) for i in enc["indexes"]) > 0
    assert enc["strings"][1] == jenc["strings"][1]
    assert enc["strings"][0][0] == jenc["strings"][0][0]
    assert tuple(enc["shape"]) == tuple(jenc["shape"])


def check_cross_decoding(c: dict):
    """Each package decodes the other's lane stream."""
    lane, jcodec, enc, jenc = (c[k] for k in ("lane", "jcodec", "enc",
                                              "jenc"))
    ours = lane.decompress(jenc["strings"], jenc["shape"])
    theirs = jcodec.decompress(enc["strings"], enc["shape"])
    for s, d in zip(enc["symbols"], ours["symbols"]):
        np.testing.assert_array_equal(d.numpy(), s)
    np.testing.assert_allclose(ours["x_hat"].numpy(),
                               np.asarray(theirs["x_hat"]), atol=FORWARD_TOL)


def check_lane_and_host(c: dict):
    """Fused and per-slice lane decompress and the host coder's round trip
    give the same symbols and bit-equal x_hat; lane and host z strings are
    the same."""
    lane, enc, x = c["lane"], c["enc"], c["x"]
    fused = lane.decompress(enc["strings"], enc["shape"])
    lane.fused = False
    try:
        walk = lane.decompress(enc["strings"], enc["shape"])
    finally:
        lane.fused = True
    host = Codec(c["port"], coder="host", device="cpu")
    henc = host.compress(x)
    hdec = host.decompress(henc["strings"], henc["shape"])
    assert henc["strings"][1] == enc["strings"][1]
    for s, h, f, w, hd in zip(enc["symbols"], henc["symbols"],
                              fused["symbols"], walk["symbols"],
                              hdec["symbols"]):
        for got in (h, f, w, hd):
            assert torch.equal(got, s)
    assert torch.equal(fused["x_hat"], walk["x_hat"])
    assert torch.equal(hdec["x_hat"], fused["x_hat"])
    assert fused["x_hat"].shape == (2,) + x.shape[1:3] + (3,)


def check_tier(c: dict, tier):
    """A fused encode tier, run eagerly on the CPU, gives the per-slice
    stream from byte 1 on with the fused-encode flag and keeps its tier
    (its self-check's decode passes; warnings are errors)."""
    codec = Codec(c["port"], coder="lane", device="cpu", fused_encode=tier)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = codec.compress(c["x"])
    want = c["enc"]["strings"]
    assert got["strings"][0][0][0] == want[0][0][0] | 1
    assert got["strings"][0][0][1:] == want[0][0][1:]
    assert got["strings"][1] == want[1]
    assert codec.fused_encode
    assert codec._fused_mode == ("full" if tier is True else "split")
