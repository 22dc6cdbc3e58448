"""The port's lane coder against the JAX one: tables, encoder bytes, and
kernel B2's plain version (`lane_decode_plain`, what the wrapper runs on
CPU tensors), which must be symbol-exact."""

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
import _lane_stress as ls
from stf_tpu.ans import lane_coder as jlc
from stf_tpu.entropy import build_gc_tables as jax_build_gc_tables
from stf_tpu_torch.ans import lane_coder as lc
from stf_tpu_torch.entropy import build_gc_tables, get_scale_table


@pytest.fixture(scope="module")
def tables():
    full = build_gc_tables(get_scale_table())
    return lc.truncate_tables(*full.astuple(), max_half=62)


def test_truncated_tables_match_jax(tables):
    ref = jlc.truncate_tables(
        *jax_build_gc_tables(get_scale_table()).astuple(), max_half=62
    )
    for got, want in zip(tables, ref):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tables.cdf.shape == (64, 127)


def _symbols(n, seed, n_escape=0):
    """Seeded (symbols, indexes): Gaussian symbols under random table rows,
    the first n_escape forced outside the ±62 window."""
    rng = np.random.default_rng(seed)
    scales = get_scale_table()
    idx = rng.integers(0, 40, n).astype(np.int32)
    sym = np.rint(rng.normal(0, scales[idx] * 0.7)).astype(np.int32)
    k = min(n_escape, n)
    sym[:k] = rng.integers(63, 5000, k) * rng.choice([-1, 1], k)
    return sym, idx


# escapes; n not a multiple of 128; n < 1024 (some groups hold only padding)
CASES = [(5000, 300), (3000 + 77, 0), (700, 5), (129, 1)]


@pytest.mark.parametrize("n,n_escape", CASES)
def test_encoder_bytes_match_jax(tables, n, n_escape):
    sym, idx = _symbols(n, n + 1, n_escape)
    got = lc.pack_lane_stream([lc.lane_encode(sym, idx, tables)])
    want = jlc.pack_lane_stream([jlc.lane_encode(sym, idx, tables)])
    assert got == want


@pytest.mark.parametrize("n,n_escape", CASES)
def test_plain_decode_is_symbol_exact(tables, n, n_escape):
    sym, idx = _symbols(n, n + 2, n_escape)
    stream = lc.lane_encode(sym, idx, tables)
    assert (stream.side.size > 0) == (n_escape > 0)
    # framed and unframed, as the codec sees it
    (stream,) = lc.unpack_lane_stream(lc.pack_lane_stream([stream]))
    words = lc.pack_word_banks(stream, lc.words_rows_for(stream.word_counts.max()))
    side = lc.pad_side_banks(stream, lc.side_rows_for(stream.side_counts.max()))
    got = lc.lane_decode(
        torch.from_numpy(idx), torch.from_numpy(words), torch.from_numpy(side),
        lc.states_tensor(stream, "cpu"), *lc.table_tensors(tables, "cpu"), n,
    )
    assert got.dtype == torch.int32 and got.shape == (n,)
    got = got.numpy()
    np.testing.assert_array_equal(got, sym)
    np.testing.assert_array_equal(
        got, jlc.lane_decode_reference(stream, idx, tables)
    )
    np.testing.assert_array_equal(
        got, np.asarray(jlc.lane_decode(stream, idx, tables, interpret=True))
    )


def test_port_decodes_jax_stream(tables):
    sym, idx = _symbols(2500, 9, 40)
    (stream,) = lc.unpack_lane_stream(
        jlc.pack_lane_stream([jlc.lane_encode(sym, idx, tables)])
    )
    np.testing.assert_array_equal(
        lc.lane_decode_reference(stream, idx, tables), sym
    )


# kernel B2's staging stress cases (the card tests in test_torch_cuda.py
# run them at full size): name -> (symbols, indexes) at CPU size. 32 and
# 33 rows a group are a multiple of the kernel's chunk (8, 16 or 32 rows)
# and one row more.
def _stress(name, tables):
    if name == "main_path_like":
        return ls.gaussian(4000, 11)
    if name == "all_renorm":
        return ls.all_renorm(4096, 12, tables)
    if name == "all_escapes":
        return ls.all_escapes(2048, 13)
    if name == "chunk_multiple":
        return ls.gaussian(32 * 1024, 14)
    assert name == "chunk_multiple_plus_one"
    return ls.gaussian(33 * 1024, 15)


@pytest.mark.parametrize("name", ["main_path_like", "all_renorm", "all_escapes",
                                  "chunk_multiple", "chunk_multiple_plus_one"])
def test_plain_decode_matches_jax_on_stress_streams(tables, name):
    sym, idx = _stress(name, tables)
    stream = lc.lane_encode(sym, idx, tables)
    tg = lc.rows_per_group(sym.size)
    if name == "all_renorm":  # every lane of every row takes a word
        np.testing.assert_array_equal(stream.word_counts, tg * lc.K)
    if name == "all_escapes":
        np.testing.assert_array_equal(stream.side_counts, tg * lc.K)
    words, side = ls.banks(stream, bucket=True)
    got = lc.lane_decode(
        torch.from_numpy(idx), torch.from_numpy(words), torch.from_numpy(side),
        lc.states_tensor(stream, "cpu"), *lc.table_tensors(tables, "cpu"),
        sym.size,
    ).numpy()
    np.testing.assert_array_equal(got, sym)
    np.testing.assert_array_equal(
        got, np.asarray(jlc.lane_decode(stream, idx, tables, interpret=True))
    )


def test_corrupt_stress_stream_reads_past_its_bank(tables):
    """The card test's corrupt stream: decoded under wrong indexes, every
    group's cursor runs past its word bank, so random words there change
    the output, where the bank's own end gives zeros."""
    sym, idx, wrong = ls.corrupt(33 * 1024, 16)
    stream = lc.lane_encode(sym, idx, tables)
    words, side = ls.banks(stream)
    rest = (torch.from_numpy(side), lc.states_tensor(stream, "cpu"),
            *lc.table_tensors(tables, "cpu"), sym.size)
    wrong_t = torch.from_numpy(wrong)
    zeros = lc.lane_decode(wrong_t, torch.from_numpy(words), *rest).numpy()
    noise = lc.lane_decode(
        wrong_t, torch.from_numpy(ls.past_the_bank(words)), *rest
    ).numpy()
    differs = (zeros != noise).reshape(lc.GROUPS, -1, lc.K).any(-1)
    assert differs.any(-1).all()
    # past the first chunk of 16 rows, inside the rows the kernel stages
    assert (differs.argmax(-1) >= 16).all()
    assert not np.array_equal(zeros, sym)
