"""The codec options of the JAX package's `Codec` that the port's takes:
`pipeline`, `pack_drain`, `analyze_chunks` / `synth_chunks` and the
`probe` / `prefetch` hooks, in f32 on the CPU for the small WACNN of
tests/test_lane_codec.py, against the JAX codec at the same weights.

Integers and bytes must match exactly: at pipeline 2 the lane stream has
one segment per (slice, sub-batch), in that order, written by both
packages byte for byte (per-slice and fused encode), and each package
decodes the other's; host y-streams are per image and the same at any
pipeline; the packed drain (12 bits a symbol) writes the same streams as
the int8 drain. Floats: cross-decoded x_hat within 1e-4 (the frameworks'
CPU convolutions sum in other orders), and a chunked synthesis's x_hat
within 1e-5 of the unchunked one.

The probe's boundaries also cut each call into spans while a torch
profiler records (`stf_tpu_torch.utils.tracing`): their nesting, names,
profiler ranges and counters are held here, and that nothing is kept or
entered without a profiler.
"""

import contextlib
import json
import warnings

import numpy as np
import pytest
import torch

from _torch_port import pair_from_port, smooth_images
from _torch_port import one_torch_thread  # noqa: F401 (autouse)
from stf_tpu.models import Codec as JaxCodec
from stf_tpu.models.codec import _unpack12 as jax_unpack12
from stf_tpu_torch.models import Codec
from stf_tpu_torch.models import codec as codec_mod
from stf_tpu_torch.utils import tracing

WIDE_TABLE = np.exp(np.linspace(np.log(0.11), np.log(256.0), 128)).astype(
    np.float32
)


def _marks():
    """(probe, marks): a probe that records each phase name."""
    marks = []
    return (lambda name, _tensor: marks.append(name)), marks


@pytest.fixture(scope="module")
def setup():
    """The JAX codecs (pipeline-2 lane, pipeline-2 fused encode, host with
    chunks of 2) and their compress of two 64x64 images, each with a
    probe; the port's pipeline-2 lane compress. The JAX codecs decode
    through their per-slice walk, and the fused encoder skips its
    self-check (`fused_verify=False`): their fused decode programs cost
    ~10 CPU-seconds each to compile, and the port's own self-check is
    tested in tests/test_torch_fused_encode.py."""
    jmodel, params, port = pair_from_port(seed=11)
    x = smooth_images(2, 64, 64, seed=3)
    out = dict(jmodel=jmodel, params=params, port=port, x=x, marks={})
    for name, kw in (
        ("lane2", dict(coder="lane", pipeline=2)),
        ("fused2", dict(coder="lane", pipeline=2, fused_encode=True,
                        fused_verify=False)),
        ("host_chunks", dict(coder="host", analyze_chunks=2, synth_chunks=2)),
    ):
        codec = JaxCodec(jmodel, params, **kw)
        codec.fused = False
        probe, marks = _marks()
        out[name] = codec, codec.compress(x, probe=probe)
        out["marks"][name] = marks
    lane2 = Codec(port, coder="lane", device="cpu", pipeline=2)
    out["port_lane2"] = lane2, lane2.compress(x)
    return out


def _y(enc):
    return enc["strings"][0][0]


# -- pipeline 2 -----------------------------------------------------------------

def test_pipeline2_lane_stream_equals_jax(setup):
    (lane2, enc), (_, jenc) = setup["port_lane2"], setup["lane2"]
    assert lane2._sub_batches(2) == [(0, 1), (1, 2)]
    assert _y(enc) == _y(jenc)
    assert enc["strings"][1] == jenc["strings"][1]
    # one segment a (slice, sub-batch): 4 x 2 hashes after the header
    assert len(codec_mod.lc.unpack_lane_stream(_y(enc)[4 + 4 * 8:])) == 8


def test_pipeline2_fused_encode_stream_equals_jax(setup):
    """The full tier at pipeline 2 (analysis and hyper at the full batch,
    the walk per sub-batch) writes the JAX fused encoder's stream, flag
    included, which is the per-slice stream from byte 1 on."""
    _, jenc = setup["fused2"]
    for tier in (True, "split"):
        codec = Codec(setup["port"], coder="lane", device="cpu", pipeline=2,
                      fused_encode=tier)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            enc = codec.compress(setup["x"])
        assert enc["strings"] == jenc["strings"]
        assert _y(enc)[0] & 1
        assert _y(enc)[1:] == _y(setup["port_lane2"][1])[1:]


def test_each_package_decodes_the_others_pipeline2_stream(setup):
    (lane2, enc), (jcodec, jenc) = setup["port_lane2"], setup["lane2"]
    ours = lane2.decompress(jenc["strings"], jenc["shape"])
    for s, d in zip(enc["symbols"], ours["symbols"]):
        assert torch.equal(d, s)
    theirs = jcodec.decompress(enc["strings"], enc["shape"])
    np.testing.assert_allclose(ours["x_hat"].numpy(),
                               np.asarray(theirs["x_hat"]), atol=1e-4)


def test_pipeline2_fused_and_per_slice_decompress_agree(setup):
    """The fused decompress at pipeline 2 (the walk, then the split
    synthesis) against the per-slice walk: same symbols, bit-equal x_hat;
    a pipeline-1 codec refuses the stream."""
    lane2, enc = setup["port_lane2"]
    fused = lane2.decompress(enc["strings"], enc["shape"])
    lane2.fused = False
    try:
        walk = lane2.decompress(enc["strings"], enc["shape"])
    finally:
        lane2.fused = True
    assert torch.equal(fused["x_hat"], walk["x_hat"])
    for s, f, w in zip(enc["symbols"], fused["symbols"], walk["symbols"]):
        assert torch.equal(f, s) and torch.equal(w, s)
    lane1 = Codec(setup["port"], coder="lane", device="cpu")
    with pytest.raises(ValueError):  # its header has 4 hashes, not 8
        lane1.decompress(enc["strings"], enc["shape"])


def test_host_streams_are_the_same_at_pipeline_1_and_2(setup):
    port, x = setup["port"], setup["x"]
    one = Codec(port, coder="host", device="cpu").compress(x)
    two = Codec(port, coder="host", device="cpu", pipeline=2)
    enc = two.compress(x)
    assert enc["strings"] == one["strings"]
    dec = two.decompress(enc["strings"], enc["shape"])
    for s, d in zip(enc["symbols"], dec["symbols"]):
        assert torch.equal(d, s)


def test_an_odd_batch_falls_back_to_pipeline_1(setup):
    port = setup["port"]
    x = smooth_images(3, 64, 64, seed=4)
    two = Codec(port, coder="lane", device="cpu", pipeline=2)
    assert two._sub_batches(3) == [(0, 3)]
    enc = two.compress(x)
    assert enc["strings"] == Codec(port, coder="lane",
                                   device="cpu").compress(x)["strings"]
    dec = two.decompress(enc["strings"], enc["shape"])
    assert dec["x_hat"].shape == (3, 64, 64, 3)


# -- the packed drain -----------------------------------------------------------

def test_unpack12_and_pack12_match_the_jax_drain(setup):
    """`pack12` writes the bytes of the JAX codec's `quantize_packed` for
    the same (q, idx), odd counts included, and `_unpack12` inverts them
    as the JAX helper does."""
    jcodec, _ = setup["host_chunks"]
    rng = np.random.default_rng(0)
    for n in (1, 7, 128, 1001):
        y = rng.normal(0, 8.0, n).astype(np.float32)
        mu = rng.normal(0, 0.5, n).astype(np.float32)
        idx = rng.integers(0, 64, n).astype(np.uint8)
        q32, jpacked, fits, *_ = jcodec._quantize_packed(y, mu, idx)
        q32 = np.asarray(q32)
        assert bool(fits) == bool(((q32 >= -32) & (q32 <= 31)).all())
        q = torch.round(torch.from_numpy(y) - torch.from_numpy(mu)).to(torch.int32)
        packed = codec_mod.pack12(q.clamp(-32, 31), torch.from_numpy(idx))
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        sym, got_idx = codec_mod._unpack12(packed.numpy(), n)
        want_sym, want_idx = jax_unpack12(packed.numpy(), n)
        np.testing.assert_array_equal(sym, want_sym)
        np.testing.assert_array_equal(got_idx, want_idx)
        np.testing.assert_array_equal(sym, q.clamp(-32, 31).numpy())
        np.testing.assert_array_equal(got_idx, idx)


def test_packed_host_streams_equal_unpacked_and_jax(setup, monkeypatch):
    port, x = setup["port"], setup["x"]
    packed = Codec(port, coder="host", device="cpu")
    plain = Codec(port, coder="host", device="cpu", pack_drain=False)
    assert packed._pack_drain and not plain._pack_drain
    kinds = []
    real = codec_mod.pack12
    monkeypatch.setattr(codec_mod, "pack12",
                        lambda q, i: kinds.append(1) or real(q, i))
    enc = packed.compress(x)
    assert len(kinds) == 4  # every slice drained packed
    assert enc["strings"] == plain.compress(x)["strings"]
    chunked = Codec(port, coder="host", device="cpu", analyze_chunks=2,
                    synth_chunks=2)
    assert enc["strings"] == chunked.compress(x)["strings"]
    assert enc["strings"] == setup["host_chunks"][1]["strings"]


def test_packed_drain_falls_back_past_six_bits(setup, monkeypatch):
    """y amplified 40x (in both codecs, so both walk the same symbols):
    slices with |q| > 31 take the int8/int32 drain, and the streams still
    equal the unpacked codec's."""
    port = setup["port"]
    x = smooth_images(1, 64, 64, seed=9)
    codecs = [Codec(port, coder="host", device="cpu", pack_drain=p)
              for p in (True, False)]
    for c in codecs:
        real = c._analyze
        monkeypatch.setattr(c, "_analyze", lambda xx, real=real: tuple(
            t * f for t, f in zip(real(xx), (40.0, 1.0))))
    packs, real_pack = [], codec_mod.pack12
    monkeypatch.setattr(codec_mod, "pack12",
                        lambda q, i: packs.append(1) or real_pack(q, i))
    enc = codecs[0].compress(x)
    assert max(int(s.abs().max()) for s in enc["symbols"]) > 31
    assert len(packs) < 4  # a slice fell back
    assert enc["strings"] == codecs[1].compress(x)["strings"]
    dec = codecs[0].decompress(enc["strings"], enc["shape"])
    for s, d in zip(enc["symbols"], dec["symbols"]):
        assert torch.equal(d, s)


def test_pack_drain_needs_a_narrow_scale_table(setup):
    port = setup["port"]
    with pytest.raises(ValueError, match="pack_drain"):
        Codec(port, device="cpu", scale_table=WIDE_TABLE, pack_drain=True)
    assert not Codec(port, device="cpu", scale_table=WIDE_TABLE)._pack_drain
    auto = Codec(port, device="cpu")
    assert auto._pack_drain
    auto.update(scale_table=WIDE_TABLE)
    assert not auto._pack_drain
    forced = Codec(port, device="cpu", pack_drain=True)
    with pytest.raises(ValueError, match="pack_drain"):
        forced.update(scale_table=WIDE_TABLE)


# -- chunks -------------------------------------------------------------------

def test_chunked_transforms(setup):
    """Chunks of 2 give the unchunked codec's lane stream and an x_hat
    within 1e-5 of its; a batch of 3 runs unchunked. (Against the JAX
    codec at chunks of 2: `test_packed_host_streams_equal_unpacked_and_jax`.)"""
    port, x = setup["port"], setup["x"]
    chunked = Codec(port, coder="lane", device="cpu", analyze_chunks=2,
                    synth_chunks=2)
    plain = Codec(port, coder="lane", device="cpu")
    enc = chunked.compress(x)
    assert enc["strings"] == plain.compress(x)["strings"]
    got = chunked.decompress(enc["strings"], enc["shape"])
    want = plain.decompress(enc["strings"], enc["shape"])
    np.testing.assert_allclose(got["x_hat"].numpy(), want["x_hat"].numpy(),
                               atol=1e-5)
    odd = smooth_images(3, 64, 64, seed=4)
    enc3 = chunked.compress(odd)
    assert enc3["strings"] == plain.compress(odd)["strings"]
    dec3 = chunked.decompress(enc3["strings"], enc3["shape"])
    assert torch.equal(dec3["x_hat"],
                       plain.decompress(enc3["strings"], enc3["shape"])["x_hat"])


# -- the hooks ------------------------------------------------------------------

def test_probe_phases_match_jax(setup):
    """The probe's phase names and order equal the JAX codec's for the same
    configuration: the per-slice lane compress at pipeline 2, the host
    compress, the full tier's compress (its first call adds fused_verify
    after its self-check, the JAX codec's last mark, which the JAX codec
    here skips), and the per-slice lane and host decompress. The fused
    decompress's marks are the JAX `_fused_decompress`'s, in its order."""
    port, x, marks = setup["port"], setup["x"], setup["marks"]
    cases = (
        ("lane2", Codec(port, coder="lane", device="cpu", pipeline=2)),
        ("fused2", Codec(port, coder="lane", device="cpu", pipeline=2,
                         fused_encode=True)),
        ("host_chunks", Codec(port, coder="host", device="cpu",
                              analyze_chunks=2, synth_chunks=2)),
    )
    for name, codec in cases:
        probe, got = _marks()
        enc = codec.compress(x, probe=probe)
        if name == "fused2":
            assert got == marks[name] + ["fused_verify"]
            probe, got = _marks()
            codec.compress(x, probe=probe)
        assert got == marks[name], name
        if name == "fused2":
            continue
        jcodec, jenc = setup[name]
        jprobe, want = _marks()
        jcodec.decompress(jenc["strings"], jenc["shape"], probe=jprobe)
        codec.fused = False
        probe, got = _marks()
        codec.decompress(enc["strings"], enc["shape"], probe=probe)
        assert got == want, name
    assert marks["lane2"] == ["upload", "analyze", "hyper", "walk", "entropy",
                              "z_rans"]
    assert marks["host_chunks"] == ["upload", "analyze", "hyper", "walk",
                                    "drain", "rans", "z_rans"]
    lane2, enc = setup["port_lane2"]
    probe, got = _marks()
    lane2.decompress(enc["strings"], enc["shape"], probe=probe)
    assert got == ["z_host_rans", "y_unpack", "banks_pack", "banks_upload",
                   "fused_walk_synth"]


def test_probe_passes_device_tensors_without_waiting(setup):
    """Each mark with a tensor gets one (the upload, y, the scales, the
    last symbols); the others get None."""
    seen = []
    codec = Codec(setup["port"], coder="lane", device="cpu")
    codec.compress(setup["x"], probe=lambda n, t: seen.append((n, t)))
    assert [n for n, t in seen if torch.is_tensor(t)] == [
        "upload", "analyze", "hyper", "walk"]
    assert [n for n, t in seen if t is None] == ["entropy", "z_rans"]


@pytest.mark.parametrize("fused", [False, True])
def test_prefetch_fires_once(setup, fused):
    codec = Codec(setup["port"], coder="lane", device="cpu",
                  fused_encode=fused)
    plain = codec.compress(setup["x"])
    calls = []
    enc = codec.compress(setup["x"], prefetch=lambda: calls.append(1))
    assert len(calls) == 1
    assert enc["strings"] == plain["strings"]


def test_prefetch_fires_once_across_the_fused_fallback(setup, monkeypatch):
    codec = Codec(setup["port"], coder="lane", device="cpu", fused_encode=True)
    real = codec._build_lane_stream

    def overflow_fused_only(*args, flags=0):
        if flags & codec_mod._LANE_FLAG_FUSED_ENC:
            raise codec_mod._LaneSideOverflow("planted")
        return real(*args, flags=flags)

    monkeypatch.setattr(codec, "_build_lane_stream", overflow_fused_only)
    calls = []
    probe, marks = _marks()
    enc = codec.compress(setup["x"], probe=probe,
                         prefetch=lambda: calls.append(1))
    assert len(calls) == 1
    assert not _y(enc)[0] & 1  # the per-slice stream
    assert "fused_encode_fallback" in marks
    assert marks.index("fused_encode_fallback") < marks.index("analyze")


# -- spans and counters ---------------------------------------------------------

@contextlib.contextmanager
def _recording():
    """A CPU-only torch profiler around the block; yields the list that
    receives the records of the codec calls made inside it."""
    from torch.profiler import ProfilerActivity, profile

    old = tracing.calls()
    last = old[-1].id if old else -1
    got = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield got, prof
    got += [c for c in tracing.calls() if c.id > last]


def _check_nesting(call):
    """Every child span lies inside its parent, and the top-level spans of
    the call's own phase follow one another; returns their names."""
    top = []
    for s in call.spans:
        assert s.t0 <= s.t1
        if s.parent is None:
            if top:
                assert top[-1].t1 <= s.t0
            top.append(s)
        else:
            parent = call.spans[s.parent]
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1, (s.name, parent.name)
    assert all(s.phase == call.phase and s.kind == "stage" for s in top)
    return [s.name for s in top]


@pytest.mark.parametrize("tier", [False, True], ids=["per_slice", "full"])
def test_spans_nest_and_take_the_probes_names(setup, tier):
    """A pipeline-2 lane compress (per-slice, or the full tier's first call
    with its self-check decompress inside) and its fused decompress: the
    top-level spans are the probe's names in its order, then "tail", with
    a probe and without; the self-check's spans lie inside self_check."""
    names = []
    for with_probe in (True, False):
        codec = Codec(setup["port"], coder="lane", device="cpu", pipeline=2,
                      fused_encode=tier)
        probe, marks = _marks() if with_probe else (None, None)
        dprobe, dmarks = _marks() if with_probe else (None, None)
        with _recording() as (calls, _):
            enc = codec.compress(setup["x"], probe=probe)
            codec.decompress(enc["strings"], enc["shape"], probe=dprobe)
        assert [c.phase for c in calls] == ["encode", "decode"]
        got = [_check_nesting(c) for c in calls]
        if with_probe:
            assert got == [marks + ["tail"], dmarks + ["tail"]]
        names.append(got)
        inner = [s for s in calls[0].spans if s.phase == "decode"]
        assert bool(inner) == tier
        if tier:
            check = [i for i, s in enumerate(calls[0].spans)
                     if s.name == "self_check"]
            assert len(check) == 1
            assert {s.parent for s in inner if s.kind == "stage"} == set(check)
    assert names[0] == names[1]


def test_no_profiler_keeps_nothing_and_enters_no_range(setup, monkeypatch):
    """Without a profiler a compress and decompress (full tier, first call
    and self-check included) build no record, enter no profiler range and
    keep nothing in the ring."""
    def refuse(*args, **kwargs):
        raise AssertionError("entered while no profiler records")

    before = tracing.calls()
    monkeypatch.setattr(tracing, "Call", refuse)
    monkeypatch.setattr(tracing, "Span", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    codec = Codec(setup["port"], coder="lane", device="cpu", pipeline=2,
                  fused_encode=True)
    probe, marks = _marks()
    enc = codec.compress(setup["x"], probe=probe)
    codec.decompress(enc["strings"], enc["shape"])
    assert marks == setup["marks"]["fused2"] + ["fused_verify"]
    assert tracing.calls() == before


def test_profiler_ranges_are_the_spans_inside_the_callers_range(setup,
                                                                tmp_path):
    """Under a CPU-only profiler the exported trace holds one range
    "stf_tpu_torch.<phase>.<span>" a span, each inside the caller's own
    range and inside its parent span's range."""
    from torch.autograd.profiler import record_function

    lane2, enc = setup["port_lane2"]
    with _recording() as (calls, prof):
        with record_function("caller"):
            lane2.compress(setup["x"])
            lane2.decompress(enc["strings"], enc["shape"])
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    caller = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e["name"] == "caller"]
    ranges = sorted((e["ts"], -e["dur"], e["name"]) for e in events
                    if e["name"].startswith("stf_tpu_torch."))
    spans = sorted(((s.t0, -(s.t1 - s.t0)), f"stf_tpu_torch.{s.phase}.{s.name}",
                    c.id, i) for c in calls for i, s in enumerate(c.spans))
    assert len(caller) == 1 and len(calls) == 2
    assert [r[2] for r in ranges] == [s[1] for s in spans]
    assert not any(e["name"].startswith("codecbench.") for e in events)
    (a, b) = caller[0]
    assert all(a <= t0 and t0 - d <= b for t0, d, _ in ranges)
    # ranges open in the spans' order, so a span's parent's range is the
    # range of its parent's position
    at = {(cid, i): k for k, (_, _, cid, i) in enumerate(spans)}
    for c in calls:
        for i, s in enumerate(c.spans):
            if s.parent is not None:
                t0, d, _ = ranges[at[(c.id, i)]]
                p0, pd, _ = ranges[at[(c.id, s.parent)]]
                assert p0 <= t0 and t0 - d <= p0 - pd


def test_framing_bytes_of_a_pipeline2_stream(setup):
    """2 images at pipeline 2: 8 segments. The framing is the header word,
    8 index hashes, the lane format's fixed bytes for 8 segments and 2
    bytes for each segment of an odd word count; the record keeps the
    stream's y and z bytes, its images and the eager outcome."""
    lane2, _ = setup["port_lane2"]
    with _recording() as (calls, _):
        enc = lane2.compress(setup["x"])
    blob = _y(enc)
    odd = sum(int(s.word_counts.sum()) & 1
              for s in codec_mod.lc.unpack_lane_stream(blob[4 + 4 * 8:]))
    (call,) = calls
    assert call.framing_bytes == (codec_mod.lc.fixed_overhead_bytes(8) + 4
                                  + 32 + 2 * odd)
    assert call.y_bytes == len(blob)
    assert call.z_bytes == sum(len(s) for s in enc["strings"][1])
    assert call.images == 2 and call.outcome is None  # no fused encode tier
    with _recording() as (calls, _):
        lane2.decompress(enc["strings"], enc["shape"])
    assert [c.outcome for c in calls] == ["eager"]


@pytest.mark.parametrize("outcome", ["size_guard", "side_overflow", "demoted"])
def test_fused_outcomes_are_recorded(setup, monkeypatch, outcome):
    """The size guard (a limit of 0 symbols a slice), a planted side-channel
    overflow in the tier's walk, and a self-check that fails (the split
    tier, then disabled): each call's record holds that outcome and the
    per-slice stream the call returned."""
    codec = Codec(setup["port"], coder="lane", device="cpu",
                  fused_encode="split")
    if outcome == "size_guard":
        monkeypatch.setattr(codec_mod, "_FUSED_ENC_MAX_SLICE", 0)
    elif outcome == "side_overflow":
        real = codec._build_lane_stream

        def overflow_fused_only(*args, flags=0):
            if flags & codec_mod._LANE_FLAG_FUSED_ENC:
                raise codec_mod._LaneSideOverflow("planted")
            return real(*args, flags=flags)

        monkeypatch.setattr(codec, "_build_lane_stream", overflow_fused_only)
    else:
        def failing(strings, shape):
            raise ValueError("index hash mismatch (planted)")

        monkeypatch.setattr(codec, "decompress", failing)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with _recording() as (calls, _):
            enc = codec.compress(setup["x"])
    (call,) = calls
    assert call.outcome == outcome
    assert not _y(enc)[0] & 1
    assert [s.name for s in call.spans if s.parent is None][-2:] == [
        "z_rans", "tail"]
    assert call.framing_bytes > codec_mod.lc.fixed_overhead_bytes(4)
