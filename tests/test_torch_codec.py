"""The slice as a whole: the port's WACNN and Codec against the JAX ones at
the same (imported) weights, on CPU.

Integers must match exactly (symbols, scale indexes, z and lane y-stream
bytes); the eval forward's floats within atol 1e-4 (the two frameworks'
CPU convolutions sum in different orders, ~1e-6 per layer, through ~60
layers). At this seed no scale index or symbol sits close enough to a
rounding or table boundary to flip. The weights make every output depend
on the image, and planted faults in g_a, the attention and the hyper path
each miss that tolerance by more than tenfold (the last two tests). At
torch's default init scale none of that held: x_hat was the same for
both images, and every y likelihood was ~1.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import jax_walk_indexes, pair_from_port, smooth_images
from stf_tpu.models import Codec as JaxCodec
from stf_tpu_torch.models import Codec
from torch import nn


@pytest.fixture(scope="module")
def setup():
    jmodel, params, port = pair_from_port(seed=11)
    x = smooth_images(2, 64, 64, seed=3)
    jcodec = JaxCodec(jmodel, params, coder="lane")
    jcodec.fused = False  # the per-slice walk; test_torch_fused.py: fused
    lane = Codec(port, coder="lane", device="cpu")
    enc = lane.compress(x)
    jenc = jcodec.compress(x)
    return dict(jmodel=jmodel, params=params, port=port, x=x, jcodec=jcodec,
                lane=lane, enc=enc, jenc=jenc)


def _forward_outputs(out):
    """{name: numpy array} of an eval forward's x_hat and likelihoods."""
    return {"x_hat": np.asarray(out["x_hat"]),
            **{k: np.asarray(v) for k, v in out["likelihoods"].items()}}


@pytest.fixture(scope="module")
def forwards(setup):
    """(JAX eval forward, port eval forward) on the two test images."""
    x = setup["x"].astype(np.float32) / 255.0
    want = jax.jit(lambda params, x: setup["jmodel"].apply(
        {"params": params}, x, training=False
    ))(setup["params"], jnp.asarray(x))
    with torch.no_grad():
        got = setup["port"](torch.from_numpy(x))
    return _forward_outputs(want), _forward_outputs(got)


def test_eval_forward_matches_jax(forwards):
    want, got = forwards
    for k in ("x_hat", "y", "z"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)


def test_eval_forward_depends_on_the_image(setup, forwards):
    """Between the two test images y differs by ~9, x_hat by ~2, the y
    likelihoods by ~1 and the z likelihoods by ~1e-3, each above the 1e-4
    tolerance."""
    with torch.no_grad():
        y = setup["port"].g_a(
            torch.from_numpy(setup["x"].astype(np.float32) / 255.0)
            .permute(0, 3, 1, 2)
        )
    assert (y[0] - y[1]).abs().max() > 1
    got = forwards[1]
    for k, least in (("x_hat", 0.1), ("y", 0.1), ("z", 2e-4)):
        assert np.abs(got[k][0] - got[k][1]).max() > least, k


def _drop_gdn(m):
    m.g_a[3] = nn.Identity()


def _inverse_gdn(m):
    m.g_a[6].inverse = True


def _unshift_attention(m):
    m.g_a[4].conv_b[0].shift_size = 0


def _flip_attention_bias(m):
    t = m.g_s[0].conv_b[0].attn.relative_position_bias_table
    t.data = t.data.flip(0)


def _swap_hyper_paths(m):
    m.h_mean_s, m.h_scale_s = m.h_scale_s, m.h_mean_s


def _zero_lrp(m):
    for p in m.lrp_transforms[1].parameters():
        p.data.zero_()


@pytest.mark.parametrize("fault", [
    _drop_gdn, _inverse_gdn, _unshift_attention, _flip_attention_bias,
    _swap_hyper_paths, _zero_lrp,
], ids=lambda f: f.__name__.lstrip("_"))
def test_eval_forward_comparison_catches_planted_faults(setup, forwards, fault):
    """A copy of the port with one planted fault misses the JAX forward by
    more than ten times the 1e-4 tolerance."""
    port = copy.deepcopy(setup["port"])
    fault(port)
    with torch.no_grad():
        got = _forward_outputs(
            port(torch.from_numpy(setup["x"].astype(np.float32) / 255.0))
        )
    want = forwards[0]
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst > 1e-3, worst


def test_lane_round_trip_equals_host(setup):
    lane, enc = setup["lane"], setup["enc"]
    dec = lane.decompress(enc["strings"], enc["shape"])
    for s, d in zip(enc["symbols"], dec["symbols"]):
        np.testing.assert_array_equal(d.numpy(), s)
    host = Codec(setup["port"], coder="host", device="cpu")
    henc = host.compress(setup["x"])
    assert henc["strings"][1] == enc["strings"][1]  # same z streams
    assert len(henc["strings"][0]) == 2  # per-image y streams
    hdec = host.decompress(henc["strings"], henc["shape"])
    assert torch.equal(hdec["x_hat"], dec["x_hat"])
    assert dec["x_hat"].shape == (2, 64, 64, 3)


def test_indexes_and_streams_match_jax(setup):
    enc, jenc = setup["enc"], setup["jenc"]
    walk = jax_walk_indexes(setup["jcodec"], setup["x"])
    assert len(walk) == len(enc["indexes"]) == 4
    for (q, idx), s, i in zip(walk, enc["symbols"], enc["indexes"]):
        np.testing.assert_array_equal(i, idx.astype(np.int32))
        np.testing.assert_array_equal(s, q)
    assert enc["strings"][1] == jenc["strings"][1]  # z strings
    assert enc["strings"][0][0] == jenc["strings"][0][0]  # lane y-stream
    assert tuple(enc["shape"]) == tuple(jenc["shape"])


def test_cross_decoding(setup):
    """Each package decodes the other's lane stream."""
    lane, jcodec, enc, jenc = (
        setup[k] for k in ("lane", "jcodec", "enc", "jenc")
    )
    ours = lane.decompress(jenc["strings"], jenc["shape"])
    theirs = jcodec.decompress(enc["strings"], enc["shape"])
    for s, d in zip(enc["symbols"], ours["symbols"]):
        np.testing.assert_array_equal(d.numpy(), s)
    np.testing.assert_allclose(
        ours["x_hat"].numpy(), np.asarray(theirs["x_hat"]), atol=1e-4
    )


def test_index_hash_mismatch_raises(setup):
    lane, enc = setup["lane"], setup["enc"]
    blob = bytearray(enc["strings"][0][0])
    blob[4] ^= 1  # first slice's index hash
    with pytest.raises(ValueError, match="hash mismatch"):
        lane.decompress([[bytes(blob)], enc["strings"][1]], enc["shape"])
