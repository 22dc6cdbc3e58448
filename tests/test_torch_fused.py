"""The device-resident lane slice on the CPU: the lane compress (kernel
B3's plain version) and the default fused lane decompress (B2 and B4
through their plain versions, run eagerly), against the host lane encoder,
the port's per-slice walk and the JAX codec's device-encode and fused
paths, at the same weights.

Streams and symbols must match exactly. The port's fused decompress must
give an x_hat bit-equal to its per-slice walk: both run the same model
calls on operands of the same values and strides (the pins only copy).
Against the JAX fused decompress x_hat agrees within atol 1e-4 (the two
frameworks' CPU convolutions sum in different orders, ~1e-6 per layer).
"""

import warnings

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_port import pair_from_port, smooth_images
from stf_tpu.models import Codec as JaxCodec
from stf_tpu_torch.ans import lane_coder as lc
from stf_tpu_torch.models import Codec
from stf_tpu_torch.models.codec import _LANE_HEADER_MAGIC, idx_hash


@pytest.fixture(scope="module")
def setup():
    jmodel, params, port = pair_from_port(seed=4)
    x = smooth_images(2, 64, 64, seed=5)
    lane = Codec(port, coder="lane", device="cpu")
    jcodec = JaxCodec(jmodel, params, coder="lane", device_encode=True)
    return dict(
        port=port, x=x, lane=lane, jcodec=jcodec, enc=lane.compress(x),
        jenc=jcodec.compress(x),
    )


def test_device_encode_stream_matches_host_encoder_and_jax(setup):
    """The stream equals the host lane encoder's on the same symbols and
    the JAX codec's device-encoded stream, byte for byte."""
    lane, enc, jenc = setup["lane"], setup["enc"], setup["jenc"]
    hashes = [idx_hash(i.reshape(-1)).item() for i in enc["indexes"]]
    host = (
        np.asarray([_LANE_HEADER_MAGIC] + hashes, "<u4").tobytes()
        + lc.pack_lane_stream([
            lc.lane_encode(s.numpy().reshape(-1), i.numpy().reshape(-1),
                           lane.lane_tables)
            for s, i in zip(enc["symbols"], enc["indexes"])
        ])
    )
    assert enc["strings"][0][0] == host == jenc["strings"][0][0]
    assert enc["strings"][1] == jenc["strings"][1]
    assert enc["host_encoded"] == 0


def test_overflowed_segment_is_reencoded_on_the_host(setup, monkeypatch):
    """A B3 segment that flags side-channel overflow goes to the host
    encoder from the same symbols; the stream does not change."""
    real = lc.lane_encode_device
    calls = []

    def flag_second(*args):
        words, side, states, counts = real(*args)
        calls.append(None)
        if len(calls) == 2:
            counts = counts.clone()
            counts[3, 2] = 1
        return words, side, states, counts

    monkeypatch.setattr(lc, "lane_encode_device", flag_second)
    out = setup["lane"].compress(setup["x"])
    assert len(calls) == setup["port"].num_slices
    assert out["host_encoded"] == 1
    assert out["strings"] == setup["enc"]["strings"]


def test_fused_decompress_equals_per_slice_walk(setup):
    lane, enc = setup["lane"], setup["enc"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a hash fallback fails the test
        fused = lane.decompress(enc["strings"], enc["shape"])
    lane.fused = False
    try:
        walk = lane.decompress(enc["strings"], enc["shape"])
    finally:
        lane.fused = True
    for s, f, w in zip(enc["symbols"], fused["symbols"], walk["symbols"]):
        np.testing.assert_array_equal(f.numpy(), s)
        np.testing.assert_array_equal(w.numpy(), s)
    assert fused["x_hat"].shape == (2, 64, 64, 3)
    assert torch.equal(fused["x_hat"], walk["x_hat"])


def test_cross_decoding_against_jax_fused(setup):
    """Each package's fused decompress decodes the other's device-encoded
    stream."""
    lane, jcodec, enc, jenc = (
        setup[k] for k in ("lane", "jcodec", "enc", "jenc")
    )
    assert jcodec.fused
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ours = lane.decompress(jenc["strings"], jenc["shape"])
        theirs = jcodec.decompress(enc["strings"], enc["shape"])
    for s, d in zip(setup["enc"]["symbols"], ours["symbols"]):
        np.testing.assert_array_equal(d.numpy(), s)
    np.testing.assert_allclose(
        ours["x_hat"].numpy(), np.asarray(theirs["x_hat"]), atol=1e-4
    )


def test_fused_hash_mismatch_warns_then_walk_raises(setup):
    lane, enc = setup["lane"], setup["enc"]
    blob = bytearray(enc["strings"][0][0])
    blob[8] ^= 1  # second slice's index hash
    with pytest.warns(RuntimeWarning, match="falling back"):
        with pytest.raises(ValueError, match="hash mismatch"):
            lane.decompress([[bytes(blob)], enc["strings"][1]], enc["shape"])
