"""The slice as a whole: the port's WACNN and Codec against the JAX ones at
the same (imported) weights, on CPU.

Integers must match exactly (symbols, scale indexes, z and lane y-stream
bytes); the eval forward's floats within atol 1e-4 (the two frameworks'
CPU convolutions sum in different orders, ~1e-6 per layer, through ~60
layers). At this seed no scale index or symbol sits close enough to a
rounding or table boundary to flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_small, port_small, smooth_images
from stf_tpu.models import Codec as JaxCodec
from stf_tpu_torch.models import Codec


@pytest.fixture(scope="module")
def setup():
    jmodel, params = jax_small(seed=11)
    # flax's he-normal init drives the random synthesis (IGDN) to outputs
    # of ~250, where f32 rounding alone exceeds 1e-4; halved synthesis
    # kernels keep x_hat in image range, as trained weights do
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 0.5 if p[0].key == "g_s" and p[-1].key == "kernel"
        else a,
        params,
    )
    port = port_small(params)
    x = smooth_images(2, 64, 64, seed=3)
    jcodec = JaxCodec(jmodel, params, coder="lane")
    jcodec.fused = False  # the per-slice walk (the port has no fused tier)
    lane = Codec(port, coder="lane", device="cpu")
    enc = lane.compress(x)
    jenc = jcodec.compress(x)
    return dict(jmodel=jmodel, params=params, port=port, x=x, jcodec=jcodec,
                lane=lane, enc=enc, jenc=jenc)


def test_eval_forward_matches_jax(setup):
    x = setup["x"].astype(np.float32) / 255.0
    want = setup["jmodel"].apply(
        {"params": setup["params"]}, jnp.asarray(x), training=False
    )
    with torch.no_grad():
        got = setup["port"](torch.from_numpy(x))
    np.testing.assert_allclose(
        got["x_hat"].numpy(), np.asarray(want["x_hat"]), atol=1e-4
    )
    for k in ("y", "z"):
        np.testing.assert_allclose(
            got["likelihoods"][k].numpy(),
            np.asarray(want["likelihoods"][k]), atol=1e-4,
        )


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


def _jax_walk_indexes(jcodec, x):
    """The JAX codec's per-slice (symbols, indexes), from the same jitted
    programs its compress() runs."""
    model = jcodec.model
    y, z = jcodec._analyze(jcodec.params, jnp.asarray(x))
    *_, z_hat = jcodec._z_quantize(z, jnp.asarray(jcodec.eb_coder.medians))
    lm, ls = jcodec._hyper(jcodec.params, z_hat, (y.shape[1], y.shape[2]))
    y_slices = jnp.split(y, model.slice_boundaries(y.shape[-1]), axis=-1)
    out = []

    def get_symbols(i, mu, idx):
        q = jnp.round(y_slices[i] - mu).astype(jnp.int32)
        out.append((np.asarray(q), np.asarray(idx)))
        return q

    jcodec._walk_slices(lm, ls, get_symbols)
    return out


def test_indexes_and_streams_match_jax(setup):
    enc, jenc = setup["enc"], setup["jenc"]
    walk = _jax_walk_indexes(setup["jcodec"], setup["x"])
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
