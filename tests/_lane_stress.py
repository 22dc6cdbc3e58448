"""Seeded lane-coder inputs that stress kernels B2's and B3's staging:
the main path's shape, every lane renormalising on every row, rows of
escapes only, a stream whose word cursor runs past its bank, row counts
at and one past a multiple of the kernels' chunks, and a side bank whose
write limit a row's start cursor meets exactly. NumPy only, so the card
tests (which import no JAX) and the JAX parity tests share them."""

import numpy as np

from stf_tpu_torch.ans import lane_coder as lc
from stf_tpu_torch.entropy import get_scale_table
from stf_tpu_torch.models.codec import _bucket

# symbols a slice on the main path: WACNN, M=320 over 10 slices, at a
# 512x768 input and batch 2 (32 channels x 32 x 48 x 2)
MAIN_PATH_N = 98_304


def gaussian(n, seed, escape_rate=0.01, rows=48):
    """(symbols, indexes) as the smoke draws them: Gaussian symbols under
    random table rows, `escape_rate` of them forced past the ±62 window."""
    rng = np.random.default_rng(seed)
    scales = get_scale_table()
    idx = rng.integers(0, rows, n).astype(np.int32)
    sym = np.rint(rng.normal(0, scales[idx] * 0.7)).astype(np.int32)
    esc = rng.random(n) < escape_rate
    k = int(esc.sum())
    sym[esc] = rng.integers(63, 3000, k) * rng.choice([-1, 1], k)
    return sym, idx


def all_renorm(n, seed, tables):
    """Symbols at the ±62 window edge under rows where their frequency is
    1, so every lane renormalises on every row: a row takes 128 words."""
    cdf = tables.cdf.astype(np.int64)
    edge = [
        r for r in range(cdf.shape[0])
        if tables.lengths[r] == cdf.shape[1]
        and all(cdf[r, s - tables.offsets[r] + 1] - cdf[r, s - tables.offsets[r]] == 1
                for s in (-62, 62))
    ]
    assert edge, "no table row gives ±62 a frequency of 1"
    rng = np.random.default_rng(seed)
    idx = rng.choice(edge, n).astype(np.int32)
    sym = (62 * rng.choice([-1, 1], n)).astype(np.int32)
    return sym, idx


def all_escapes(n, seed):
    """Every symbol outside the ±62 window: rows of escapes only."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 64, n).astype(np.int32)
    sym = (rng.integers(63, 1 << 20, n) * rng.choice([-1, 1], n)).astype(np.int32)
    return sym, idx


def side_limit(row, seed):
    """(symbols, indexes) of 6144 symbols (6 rows a group, so a side bank
    of 6 rows whose writes stop past (6 - 2) * 128 = 512 escapes) where
    group 0's escapes before row `row` (4 or more) number exactly 512:
    that row's start cursor is the limit, so it writes its 7 escapes and
    overflows the group; the row after it, where there is one, starts past
    the limit and writes none of its 5. Group 0's escape values are
    1000 + position, its other symbols 0."""
    sym, idx = gaussian(6 * lc.GROUPS * lc.K, seed, escape_rate=0.0)
    esc = np.zeros((6, lc.K), bool)
    for t in range(row):
        esc[t, : 512 // row + (t < 512 % row)] = True
    esc[row, :7] = True
    if row + 1 < 6:
        esc[row + 1, 50:55] = True
    esc = esc.reshape(-1)
    sym[: esc.size] = np.where(esc, 1000 + np.arange(esc.size), 0)
    return sym, idx


def corrupt(n, seed):
    """(symbols, indexes, decode indexes): narrow-row symbols that code to
    ~150 words a group, decoded under the widest rows, where the lanes
    renormalise often: at n = 33*1024 each group's word cursor runs past
    its 3-row bank (768 words) near row 24 of 33."""
    sym, idx = gaussian(n, seed, rows=20)
    wrong = np.random.default_rng(seed + 1).integers(56, 64, n).astype(np.int32)
    return sym, idx, wrong


def past_the_bank(words, groups=lc.GROUPS, rows=64, seed=0):
    """The word banks with `rows` rows of random words after each group's:
    a decode that reads past a bank gives other symbols with these."""
    w = words.reshape(groups, -1, lc.K)
    tail = np.random.default_rng(seed).integers(
        -(1 << 31), (1 << 31) - 1, (groups, rows, lc.K)).astype(np.int32)
    return np.concatenate([w, tail], 1).reshape(-1, lc.K)


def banks(stream, bucket=False):
    """(words, side) banks as the codec builds them; bucket=True rounds the
    row counts to a power of two as `Codec` does."""
    wr = lc.words_rows_for(stream.word_counts.max())
    sr = lc.side_rows_for(stream.side_counts.max())
    if bucket:
        wr, sr = _bucket(wr), _bucket(sr)
    return lc.pack_word_banks(stream, wr), lc.pad_side_banks(stream, sr)
