"""The fused encode tiers on the CPU (`Codec(fused_encode=True | "split")`,
the walk run eagerly through the kernels' plain versions), against the
JAX codec's fused encode, the port's per-slice compress and both port
decoders, at the same weights and input.

Streams must match exactly: the full tier's y-stream and z strings equal
the JAX fused encode's, flag included; both tiers' streams equal the
per-slice stream from byte 1 on (byte 0 carries the fused-encode flag).
The tier logic (self-check, demotion, side-overflow and z-overflow
fallbacks, the size guard, the decoders' retry) runs here as it runs on
the card; the graph capture itself is tested in test_torch_cuda.py.
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
from stf_tpu_torch.models import codec as codec_mod

TIERS = (True, "split")


@pytest.fixture(scope="module")
def setup():
    jmodel, params, port = pair_from_port(seed=4)
    x = smooth_images(2, 64, 64, seed=5)
    # the JAX fused encode program, its Pallas kernels in interpret mode;
    # test_lane_codec.py covers its own self-check
    jcodec = JaxCodec(jmodel, params, coder="lane", fused_encode=True,
                      fused_verify=False)
    lane = Codec(port, coder="lane", device="cpu")
    tiers = {t: Codec(port, coder="lane", device="cpu", fused_encode=t)
             for t in TIERS}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        encs = {t: c.compress(x) for t, c in tiers.items()}
    return dict(port=port, x=x, jenc=jcodec.compress(x), lane=lane,
                enc=lane.compress(x), tiers=tiers, encs=encs)


def _y(enc):
    return enc["strings"][0][0]


def test_full_tier_stream_equals_jax_fused_encode(setup):
    full, jenc = setup["encs"][True], setup["jenc"]
    assert _y(full)[0] & codec_mod._LANE_FLAG_FUSED_ENC
    assert _y(full) == _y(jenc)
    assert full["strings"][1] == jenc["strings"][1]
    assert tuple(full["shape"]) == tuple(jenc["shape"])


def test_split_tier_stream_equals_full_tiers(setup):
    encs = setup["encs"]
    assert encs["split"]["strings"] == encs[True]["strings"]
    assert setup["tiers"]["split"]._fused_mode == "split"
    assert setup["tiers"][True]._fused_mode == "full"


@pytest.mark.parametrize("tier", TIERS, ids=str)
def test_tier_stream_is_the_per_slice_stream_with_the_flag(setup, tier):
    enc, got = setup["enc"], setup["encs"][tier]
    assert not _y(enc)[0] & 1 and _y(got)[0] == _y(enc)[0] | 1
    assert _y(got)[1:] == _y(enc)[1:]
    assert got["strings"][1] == enc["strings"][1]
    assert got["host_encoded"] == enc["host_encoded"] == 0
    for key in ("symbols", "indexes"):
        for a, b in zip(enc[key], got[key]):
            assert torch.equal(a, b), key


@pytest.mark.parametrize("tier", TIERS, ids=str)
def test_both_decoders_take_a_tier_stream(setup, tier):
    """Fused and per-slice decode, warnings as errors: the stream's hash
    check passes in both, and their x_hat are bit-equal."""
    codec, enc = setup["tiers"][tier], setup["encs"][tier]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fused = codec.decompress(enc["strings"], enc["shape"])
        codec.fused = False
        try:
            walk = codec.decompress(enc["strings"], enc["shape"])
        finally:
            codec.fused = True
    assert torch.equal(fused["x_hat"], walk["x_hat"])
    for s, f, w in zip(enc["symbols"], fused["symbols"], walk["symbols"]):
        assert torch.equal(f, s) and torch.equal(w, s)


def _failing_decompress(codec, monkeypatch, while_mode=None):
    """Make `codec.decompress` raise a hash mismatch (only while the codec
    is in `while_mode`, if given); returns the list of its calls."""
    real, calls = codec.decompress, []

    def decompress(strings, shape):
        calls.append(codec._fused_mode)
        if while_mode is None or codec._fused_mode == while_mode:
            raise ValueError("index hash mismatch (planted)")
        return real(strings, shape)

    monkeypatch.setattr(codec, "decompress", decompress)
    return calls


def test_full_tier_self_check_failure_demotes_to_split(setup, monkeypatch):
    full = Codec(setup["port"], coder="lane", device="cpu", fused_encode=True)
    calls = _failing_decompress(full, monkeypatch, while_mode="full")
    with pytest.warns(RuntimeWarning, match="demoting to the split"):
        enc = full.compress(setup["x"])
    assert calls == ["full", "split"]
    assert full.fused_encode and full._fused_mode == "split"
    fresh = Codec(setup["port"], coder="lane", device="cpu",
                  fused_encode="split").compress(setup["x"])
    assert enc["strings"] == fresh["strings"]
    assert _y(enc)[0] & 1


def test_split_tier_self_check_failure_disables_the_tier(setup, monkeypatch):
    split = Codec(setup["port"], coder="lane", device="cpu",
                  fused_encode="split")
    calls = _failing_decompress(split, monkeypatch)
    with pytest.warns(RuntimeWarning, match="self-check FAILED"):
        enc = split.compress(setup["x"])
    assert calls == ["split"]
    assert not split.fused_encode
    assert enc["strings"] == setup["enc"]["strings"]  # never-fused codec's
    assert not _y(enc)[0] & 1
    split.compress(setup["x"])
    assert calls == ["split"]  # the per-slice walk checks nothing


def test_only_the_first_stream_of_a_configuration_is_checked(setup,
                                                             monkeypatch):
    """A configuration is (tier, input shape, dtype): a float input of the
    same shape is a second one."""
    x = setup["x"]
    full = Codec(setup["port"], coder="lane", device="cpu", fused_encode=True)
    calls = []
    real = full.decompress
    monkeypatch.setattr(full, "decompress",
                        lambda *a: (calls.append(1), real(*a))[1])
    first = full.compress(x)
    assert len(calls) == 1
    assert full.compress(x)["strings"] == first["strings"]
    assert len(calls) == 1
    full.compress(x.astype(np.float32) / 255.0)
    assert len(calls) == 2


def test_fused_encode_options(setup):
    port = setup["port"]
    assert not Codec(port, device="cpu", fused_encode=True).fused_encode
    with pytest.raises(ValueError, match="fused_encode"):
        Codec(port, coder="lane", device="cpu", fused_encode="full")


@pytest.mark.parametrize("tier", TIERS, ids=str)
def test_side_overflow_gives_the_per_slice_stream(setup, monkeypatch, tier):
    """B3 flags its second slice's side channel as overflowed in every
    walk: the tier gives up, and the per-slice compress host-encodes that
    segment; the stream has no flag."""
    real, calls = lc.lane_encode_device, []

    def overflow_second(*args):
        words, side, states, counts = real(*args)
        calls.append(None)
        if len(calls) % 4 == 2:
            counts = counts.clone()
            counts[5, 2] = 1
        return words, side, states, counts

    monkeypatch.setattr(lc, "lane_encode_device", overflow_second)
    codec = Codec(setup["port"], coder="lane", device="cpu",
                  fused_encode=tier)
    enc = codec.compress(setup["x"])
    assert len(calls) == 8  # the tier's walk, then the per-slice walk's
    assert enc["host_encoded"] >= 1
    assert enc["strings"] == setup["enc"]["strings"]
    assert codec.fused_encode


@pytest.mark.parametrize("tier", TIERS, ids=str)
def test_z_beyond_int8_takes_the_int32_symbols(setup, monkeypatch, tier):
    """One z symbol planted at +300: the tier fetches z's int32 copy, and
    its z strings equal the per-slice compress's."""
    real = codec_mod._z_quantize_math

    def plant(z, medians):
        z = z.clone()
        z[0, 0, 0, 0] += 300
        return real(z, medians)

    monkeypatch.setattr(codec_mod, "_z_quantize_math", plant)
    lane = Codec(setup["port"], coder="lane", device="cpu")
    want = lane.compress(setup["x"])
    z_sym = lane.eb_coder.decompress_symbols(want["strings"][1], want["shape"])
    assert z_sym.max() > 127
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = Codec(setup["port"], coder="lane", device="cpu",
                    fused_encode=tier).compress(setup["x"])
    assert got["strings"][1] == want["strings"][1]
    assert _y(got)[1:] == _y(want)[1:] and _y(got)[0] & 1


def test_per_slice_decode_retries_the_fused_decoder(setup, monkeypatch):
    """With fused decode off, a flagged stream whose per-slice index
    derivation differs (planted: slice 0's decoded symbols shifted in the
    per-slice walk only) decodes through the fused walk; an unflagged
    stream raises. A flipped hash byte fails both decoders."""
    codec, enc = setup["tiers"][True], setup["encs"][True]
    want = codec.decompress(enc["strings"], enc["shape"])
    real = codec._lane_symbols

    def shifted(banks, ns, hashes, decoded, packed=True):
        get = real(banks, ns, hashes, decoded, packed)
        if not packed:
            return get
        return lambda i, mu, idx: get(i, mu, idx) + (i == 0)

    monkeypatch.setattr(codec, "_lane_symbols", shifted)
    codec.fused = False
    try:
        got = codec.decompress(enc["strings"], enc["shape"])
        assert torch.equal(got["x_hat"], want["x_hat"])
        unflagged = [[bytes([_y(enc)[0] & ~1]) + _y(enc)[1:]],
                     enc["strings"][1]]
        with pytest.raises(ValueError, match="hash mismatch"):
            codec.decompress(unflagged, enc["shape"])
        monkeypatch.undo()
        blob = bytearray(_y(enc))
        blob[8] ^= 1  # second slice's index hash
        with pytest.warns(RuntimeWarning, match="falling back"):
            with pytest.raises(ValueError, match="hash mismatch"):
                codec.decompress([[bytes(blob)], enc["strings"][1]],
                                 enc["shape"])
    finally:
        codec.fused = True


@pytest.mark.parametrize("tier", TIERS, ids=str)
def test_a_wrong_analysis_downsample_fails_loudly(setup, monkeypatch, tier):
    """The size guard reads y's shape off `analysis_downsample`; a model
    whose analysis disagrees fails its first compress rather than set
    the header flag where the JAX codec would not. A codec without a
    fused tier never reads it."""
    port, x = setup["port"], setup["x"]
    codec = Codec(port, coder="lane", device="cpu", fused_encode=tier)
    monkeypatch.setattr(port, "analysis_downsample", 8)
    with pytest.raises(RuntimeError, match="analysis_downsample"):
        codec.compress(x)
    lane = Codec(port, coder="lane", device="cpu")
    assert lane.compress(x)["strings"] == setup["enc"]["strings"]


def test_size_guard_from_shapes_only(setup):
    """At this model's 10-channel slices, 447^2 latent pixels a slice are
    1,998,090 symbols and 448^2 are 2,007,040 (at batch 2, 447 x 223 and
    447 x 224, latents rounded up): the tier takes the first and leaves
    the second, without reading the (broadcast, 154 MB if real) image."""
    codec = setup["tiers"][True]
    assert codec._fused_fits((1, 447 * 16, 447 * 16, 3))
    assert codec._fused_fits((2, 447 * 16 - 15, 223 * 16, 3))
    assert not codec._fused_fits((1, 448 * 16, 448 * 16, 3))
    assert not codec._fused_fits((2, 447 * 16, 223 * 16 + 1, 3))
    big = np.broadcast_to(np.zeros((1, 1, 1, 3), np.uint8),
                          (1, 448 * 16, 448 * 16, 3))
    assert codec._compress_fused(big) is None
