"""Kernel B3 (device lane encode) and kernel B4 (layout pin) of the port
against the JAX package, through their plain PyTorch versions (what the
wrappers run for CPU tensors), and the host halves beside them
(`assemble_from_tails`, `flat_banks`). Everything is integer or bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
import _lane_stress as ls
from stf_tpu.ans import lane_coder as jlc
from stf_tpu_torch.ans import lane_coder as lc
from stf_tpu_torch.entropy import build_gc_tables, get_scale_table

# what Pallas' interpreter leaves in output cells the kernel never writes
_UNWRITTEN = np.iinfo(np.int32).min


@pytest.fixture(scope="module")
def tables():
    full = build_gc_tables(get_scale_table())
    return lc.truncate_tables(*full.astuple(), max_half=62)


def _symbols(n, seed, escape_every=40):
    rng = np.random.default_rng(seed)
    scales = get_scale_table()
    idx = rng.integers(0, 40, n).astype(np.int32)
    sym = np.rint(rng.normal(0, scales[idx] * 0.7)).astype(np.int32)
    k = max(1, n // escape_every)
    sym[:k] = rng.integers(63, 3000, k) * rng.choice([-1, 1], k)
    return sym, idx


def _port_encode(sym, idx, tables):
    return lc.lane_encode_device(
        torch.from_numpy(sym), torch.from_numpy(idx),
        *lc.table_tensors(tables, "cpu"), sym.size, int(tables.offsets[0]),
    )


def _jax_encode(sym, idx, tables):
    out = jlc.lane_encode_device(
        jnp.asarray(sym), jnp.asarray(idx), *jlc.device_tables(tables),
        n=sym.size, pad_sym=int(tables.offsets[0]), interpret=True,
    )
    return [np.asarray(a).view(np.int32) for a in out]


def _assemble(out, n):
    """The LaneStream of an encoder's whole output (numpy arrays)."""
    tg, wcap_rows, scap_rows = lc.encode_caps(n)
    return lc.assemble_from_tails(
        out[0].reshape(lc.GROUPS, wcap_rows, lc.K)[:, :tg],
        out[1].reshape(lc.GROUPS, scap_rows, lc.K), out[2], out[3], n,
    )


def _assert_same_stream(got, want):
    for field in lc.LaneStream._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


# tg = 1 (one lane, one row), tg = 1 with a partial second row, tg = 4
@pytest.mark.parametrize("n", [1, 130, 3149])
def test_plain_encoder_matches_jax_kernel(tables, n):
    sym, idx = _symbols(n, n)
    got = [a.numpy() for a in _port_encode(sym, idx, tables)]
    want = _jax_encode(sym, idx, tables)
    for name, g, w in zip(("words", "side", "states", "counts"), got, want):
        assert g.shape == w.shape and g.dtype == np.int32, name
        written = w != _UNWRITTEN
        np.testing.assert_array_equal(g[written], w[written], err_msg=name)
        assert not g[~written].any(), name  # the port zeroes them
    assert not got[3][:, 2].any()
    stream = _assemble(got, n)
    _assert_same_stream(stream, lc.lane_encode(sym, idx, tables))
    assert stream.side.size == max(1, n // 40)


def test_side_overflow_is_flagged_like_jax(tables):
    """Group 0 escapes on every symbol: more than its side channel holds
    ((scap_rows - 2) * K = 512 at tg = 5), so both encoders flag it."""
    n = 5 * lc.GROUPS * lc.K
    sym, idx = _symbols(n, 7)
    sym[: 5 * lc.K] = 1000
    got = [a.numpy() for a in _port_encode(sym, idx, tables)]
    want = _jax_encode(sym, idx, tables)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3][0, 2] == 1 and not got[3][1:, 2].any()
    np.testing.assert_array_equal(got[2], want[2])  # states are unaffected


# the inputs of the B3 card tests (tests/test_torch_cuda.py) at sizes the
# interpreter runs in seconds: every lane renormalising on every row, rows
# of escapes only (every group overflows), 16 and 17 rows a group (kernel
# B3's chunk, and one more: a one-row chunk at the top), and a row whose
# start cursor is the side bank's write limit (row 4, and a row later)
@pytest.mark.parametrize("case", ["all_renorm", "all_escapes", "chunk_rows",
                                  "chunk_rows_plus_one", "side_limit_row4",
                                  "side_limit_row5"])
def test_plain_encoder_matches_jax_kernel_on_stress_inputs(tables, case):
    sym, idx = {
        "all_renorm": lambda: ls.all_renorm(17 * 1024, 32, tables),
        "all_escapes": lambda: ls.all_escapes(17 * 1024, 33),
        "chunk_rows": lambda: ls.gaussian(16 * 1024, 34),
        "chunk_rows_plus_one": lambda: ls.gaussian(17 * 1024, 35),
        "side_limit_row4": lambda: ls.side_limit(4, 36),
        "side_limit_row5": lambda: ls.side_limit(5, 37),
    }[case]()
    got = [a.numpy() for a in _port_encode(sym, idx, tables)]
    want = _jax_encode(sym, idx, tables)
    for name, g, w in zip(("words", "side", "states", "counts"), got, want):
        written = w != _UNWRITTEN
        np.testing.assert_array_equal(g[written], w[written], err_msg=name)
        assert not g[~written].any(), name
    overflow = got[3][:, 2]
    if case == "all_escapes":
        assert overflow.all()
    elif case.startswith("side_limit"):
        assert overflow[0] == 1 and not overflow[1:].any()
        side0 = got[1].reshape(lc.GROUPS, -1)[0]
        row = int(case[-1])
        # the row at the limit wrote its 7 escapes there; the row after, none
        np.testing.assert_array_equal(side0[512:519],
                                      1000 + row * lc.K + np.arange(7))
        assert not side0[519:].any()
    else:
        assert not overflow.any()
        _assert_same_stream(_assemble(got, sym.size),
                            lc.lane_encode(sym, idx, tables))


def test_escapes_beyond_2_24_are_stored(tables):
    """The TPU kernel flagged escapes of 2^24 or more (its scatter went
    through f32); the port stores them, and the stream is still the host
    encoder's."""
    sym, idx = _symbols(2000, 3)
    sym[:5] = [1 << 24, -(1 << 24) - 3, (1 << 31) - 1, -(1 << 31), 1 << 30]
    got = [a.numpy() for a in _port_encode(sym, idx, tables)]
    assert not got[3][:, 2].any()
    _assert_same_stream(
        _assemble(got, sym.size),
        lc.lane_encode(sym, idx, tables),
    )


def test_assemble_from_tails_and_flat_banks_match_jax(tables):
    segments = []
    for n, seed in ((3149, 1), (700, 2), (9000, 3)):
        sym, idx = _symbols(n, seed, escape_every=25)
        out = [a.numpy() for a in _port_encode(sym, idx, tables)]
        tg, wcap_rows, scap_rows = lc.encode_caps(n)
        # the fewest rows that hold every group's stream, as the codec takes
        wb = min(-(-int(out[3][:, 0].max()) // lc.K) + 1, tg)
        sb = min(-(-int(out[3][:, 1].max()) // lc.K) + 1, scap_rows)
        w = out[0].reshape(lc.GROUPS, wcap_rows, lc.K)[:, tg - wb:tg]
        s = out[1].reshape(lc.GROUPS, scap_rows, lc.K)[:, :sb]
        got = lc.assemble_from_tails(w, s, out[2], out[3], n)
        want = jlc.assemble_from_tails(w, s, out[2], out[3], n)
        _assert_same_stream(got, want)
        _assert_same_stream(got, lc.lane_encode(sym, idx, tables))
        segments.append(got)
    for wr, sr in ((8, 8), (16, 32)):
        flat, offs = lc.flat_banks(segments, wr, sr)
        jflat, joffs = jlc.flat_banks(segments, wr, sr)
        assert flat.dtype == jflat.dtype and offs.dtype == joffs.dtype
        np.testing.assert_array_equal(flat, jflat)
        np.testing.assert_array_equal(offs, joffs)


def _pin_cases():
    """The dtypes of tests/test_lane_codec.py's layout-pin test, plus a
    cropped (strided) f32 view like hyper_synthesize's outputs."""
    rng = np.random.default_rng(3)
    f32 = rng.normal(size=(3, 7, 11, 5)).astype(np.float32)
    f32[0, 0, 0, :3] = [np.nan, np.inf, -0.0]
    f32.view(np.int32)[1, 1, 1, 1] = 0x7FC01234  # a NaN with a payload
    bf16 = f32.astype(jnp.bfloat16)
    return {
        "f32": torch.from_numpy(f32),
        "bf16": torch.from_numpy(bf16.view(np.int16)).view(torch.bfloat16),
        "i32": torch.from_numpy(
            rng.integers(-(2**31), 2**31, 999).astype(np.int32)
        ),
        "u8": torch.from_numpy(rng.integers(0, 256, (13, 129)).astype(np.uint8)),
        "i8": torch.from_numpy(rng.integers(-128, 128, 1).astype(np.int8)),
        "f32_cropped": torch.from_numpy(f32).permute(0, 3, 1, 2)[:, :, :5, :3],
    }


@pytest.mark.parametrize("case", list(_pin_cases()))
def test_layout_pin_plain_is_bit_exact_like_jax(case):
    x = _pin_cases()[case]
    got = lc.layout_pin(x)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert got.is_contiguous() and got.data_ptr() != x.data_ptr()
    raw = lambda t: t.contiguous().view(torch.uint8).numpy().reshape(-1)  # noqa: E731
    np.testing.assert_array_equal(raw(got), raw(x))
    xj = x.contiguous().numpy() if x.dtype != torch.bfloat16 else (
        x.contiguous().view(torch.int16).numpy().view(jnp.bfloat16)
    )
    want = jax.jit(lambda a: jlc.layout_pin(a, interpret=True))(xj)
    np.testing.assert_array_equal(
        raw(got), np.asarray(want).view(np.uint8).reshape(-1)
    )
