"""Interleaved rANS "lane coder": G x 128 parallel rANS32 lanes, encoded
and decoded on the GPU.

Port of `stf_tpu/ans/lane_coder.py`: the same stream format (G = 8 row
groups x K = 128 lanes, 16-bit renormalisation, escapes to a per-group
int32 side channel, the same packed framing), so streams cross between
the two packages byte for byte. The host half (tables, native encoder,
NumPy reference decoder, framing, bank packing, the device encoder's
stream assembly) is a copy of the JAX module's. Its three Pallas kernels
become hand-written CUDA kernels, each with a plain PyTorch version that
the wrapper runs for CPU tensors:

  * `lane_decode`         kernel B2, `csrc/lane_decode.cu`;
  * `lane_encode_device`  kernel B3, `csrc/lane_encode.cu`;
  * `layout_pin`          kernel B4, `csrc/layout_pin.cu`.
"""

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _native

K = 128          # lanes per group
GROUPS = 8       # independent row groups (part of the stream format)
RANS_L = 1 << 16  # renormalization lower bound = 2^precision
PRECISION = 16
SENTINEL = 1 << 20  # table padding: never <= a 16-bit slot


class LaneTables(NamedTuple):
    """CDF tables with rows padded by SENTINEL to equal width."""

    cdf: np.ndarray      # (R, W) int32, row r valid through lengths[r]
    lengths: np.ndarray  # (R,) int32 (== pmf_len + 2, escape slot included)
    offsets: np.ndarray  # (R,) int32


class LaneStream(NamedTuple):
    """One encoded segment: per-group word/side streams + lane states."""

    words: np.ndarray        # uint16, groups concatenated
    word_counts: np.ndarray  # (G,) int64
    states: np.ndarray       # (G, K) uint32 decoder init states
    side: np.ndarray         # int32 escape values, groups concatenated
    side_counts: np.ndarray  # (G,) int64
    n: int                   # real symbol count


def make_lane_tables(cdf, cdf_lengths, offsets) -> LaneTables:
    cdf = np.asarray(cdf, np.int64)
    lengths = np.asarray(cdf_lengths, np.int32).reshape(-1)
    offsets = np.asarray(offsets, np.int32).reshape(-1)
    out = np.full(cdf.shape, SENTINEL, np.int32)
    for r in range(cdf.shape[0]):
        out[r, : lengths[r]] = cdf[r, : lengths[r]]
    return LaneTables(out, lengths, offsets)


def truncate_tables(cdf, cdf_lengths, offsets, max_half: int = 127) -> LaneTables:
    """Lane tables with every row's symbol window clamped to ±max_half
    around its center; clipped tail mass is folded into the escape slot,
    and symbols beyond the window ride the raw side channel. The codec
    uses max_half=62 (W = 127 columns), as the JAX codec does."""
    cdf = np.asarray(cdf, np.int64)
    lengths = np.asarray(cdf_lengths, np.int32).reshape(-1)
    offsets = np.asarray(offsets, np.int32).reshape(-1)
    wmax = 2 * max_half + 1 + 2
    R = cdf.shape[0]
    out_cdf = np.zeros((R, min(cdf.shape[1], wmax)), np.int64)
    out_len = np.empty(R, np.int32)
    out_off = np.empty(R, np.int32)
    for r in range(R):
        L = int(lengths[r])  # cdf entries; pmf_len = L - 2 symbols + escape
        pmf_len = L - 2
        freqs = np.diff(cdf[r, :L])  # pmf_len + 1 freqs (escape last)
        center = -int(offsets[r])
        if pmf_len <= 2 * max_half + 1:
            out_cdf[r, :L] = cdf[r, :L]
            out_len[r] = L
            out_off[r] = offsets[r]
            continue
        # wide row: keep a (2*max_half+1)-slot window around its center,
        # clipped into the row
        lo = min(max(center - max_half, 0), pmf_len - (2 * max_half + 1))
        hi = lo + 2 * max_half + 1
        kept = freqs[lo:hi]
        esc = freqs[pmf_len] + freqs[:lo].sum() + freqs[hi:pmf_len].sum()
        new = np.concatenate([[0], np.cumsum(np.concatenate([kept, [esc]]))])
        out_cdf[r, : new.size] = new
        out_len[r] = new.size
        out_off[r] = offsets[r] + lo
    return make_lane_tables(out_cdf, out_len, out_off)


def _pad_to_rows(symbols, indexes, tables: LaneTables):
    """Pad (symbols, indexes) to G*Tg full K-rows. Padding symbols encode
    as row 0 with value offsets[0] (slot 0, always in range); the decoder
    pads indexes with the same zeros, so padded tails round-trip and are
    sliced off."""
    n = symbols.size
    tg = rows_per_group(n)
    total = GROUPS * tg * K
    symbols = np.concatenate(
        [symbols, np.full(total - n, tables.offsets[0], np.int32)]
    )
    indexes = np.concatenate([indexes, np.zeros(total - n, np.int32)])
    return symbols, indexes, tg


def rows_per_group(n: int) -> int:
    """tg: K-rows each group decodes for an n-symbol segment."""
    return ((n + K - 1) // K + GROUPS - 1) // GROUPS


def lane_encode(symbols, indexes, tables: LaneTables) -> LaneStream:
    """Host encoder (native, `csrc/rans_coder.cpp` stf_lane_encode): split
    into G row groups and encode each independently."""
    from ._binding import lane_encode_groups

    symbols = np.asarray(symbols, np.int32).reshape(-1)
    indexes = np.asarray(indexes, np.int32).reshape(-1)
    n = symbols.size
    symbols, indexes, tg = _pad_to_rows(symbols, indexes, tables)
    words, word_counts, states, side, side_counts = lane_encode_groups(
        symbols, indexes, tg, GROUPS, K,
        tables.cdf, tables.lengths, tables.offsets,
    )
    return LaneStream(words, word_counts, states, side, side_counts, n)


def _decode_group_reference(words, init_states, side, indexes, tables, T):
    """Pure-NumPy forward decoder for one group (the format's oracle)."""
    idx2 = np.asarray(indexes, np.int64).reshape(T, K)
    words = np.asarray(words, np.uint64)
    state = np.asarray(init_states, np.uint64).copy()
    out = np.empty((T, K), np.int32)
    base = 0
    sbase = 0
    for t in range(T):
        idx = idx2[t]
        row = tables.cdf[idx].astype(np.int64)  # (K, W)
        lens = tables.lengths[idx].astype(np.int64)
        slot = (state & 0xFFFF).astype(np.int64)
        le = row <= slot[:, None]
        s = le[:, 1:].sum(1)  # count of cdf[j] <= slot for j >= 1
        cum = np.max(np.where(le, row, -1), axis=1)
        nxt = np.min(np.where(le, SENTINEL, row), axis=1)
        nxt = np.minimum(nxt, RANS_L)
        freq = (nxt - cum).astype(np.uint64)
        state = freq * (state >> PRECISION) + (slot - cum).astype(np.uint64)
        m = state < RANS_L
        nren = int(m.sum())
        w = np.zeros(K, np.uint64)
        w[m] = words[base : base + nren]
        state = np.where(m, (state << PRECISION) | w, state)
        base += nren
        esc = s == lens - 2
        vals = (s + tables.offsets[idx]).astype(np.int32)
        nesc = int(esc.sum())
        if nesc:
            vals[esc] = side[sbase : sbase + nesc]
            sbase += nesc
        out[t] = vals
    return out.reshape(-1)


def lane_decode_reference(
    stream: LaneStream, indexes, tables: LaneTables
) -> np.ndarray:
    """Pure-NumPy decode of one segment."""
    indexes = np.asarray(indexes, np.int32).reshape(-1)
    _, indexes, tg = _pad_to_rows(
        np.zeros(stream.n, np.int32), indexes, tables
    )
    wb = np.concatenate([[0], np.cumsum(stream.word_counts)])
    sb = np.concatenate([[0], np.cumsum(stream.side_counts)])
    out = []
    gsz = tg * K
    for g in range(GROUPS):
        out.append(
            _decode_group_reference(
                stream.words[wb[g] : wb[g + 1]],
                stream.states[g],
                stream.side[sb[g] : sb[g + 1]],
                indexes[g * gsz : (g + 1) * gsz],
                tables,
                tg,
            )
        )
    return np.concatenate(out)[: stream.n]


# -- stream framing -----------------------------------------------------------

# Format word leading every packed stream: magic byte, layout version, and
# the two constants the layout depends on (GROUPS, K).
_STREAM_MAGIC = 0x5A
_STREAM_VERSION = 1


def _format_word() -> int:
    return (
        (_STREAM_MAGIC << 24)
        | (_STREAM_VERSION << 16)
        | (GROUPS << 8)
        | (K & 0xFF)
    )


def pack_lane_stream(segments) -> bytes:
    """Serialize a list of LaneStream segments into one byte string.

    Layout (little-endian): u32 format word; u32 segment count; per
    segment u32 n_symbols, G u32 word counts, G u32 side counts; then per
    segment, in order: G*K u32 init states, words u16 (padded to 4-byte
    alignment), side i32.
    """
    head = [np.asarray([_format_word(), len(segments)], "<u4").tobytes()]
    body = []
    for seg in segments:
        head.append(np.asarray([seg.n], "<u4").tobytes())
        head.append(np.asarray(seg.word_counts, "<u4").tobytes())
        head.append(np.asarray(seg.side_counts, "<u4").tobytes())
        chunk = (
            np.asarray(seg.states, "<u4").tobytes()
            + np.asarray(seg.words, "<u2").tobytes()
        )
        if len(chunk) % 4:
            chunk += b"\x00\x00"
        body.append(chunk + np.asarray(seg.side, "<i4").tobytes())
    return b"".join(head + body)


def fixed_overhead_bytes(n_segments: int) -> int:
    """Bytes of fixed per-segment framing in a packed lane stream: the
    format word, per-segment metadata, and the G*K lane init states, the
    part that does not scale with content entropy (~4.2 KB a segment).
    Subtract it from the stream length for a host-equivalent rate
    estimate (RD curves should use the host coder directly)."""
    return 8 + n_segments * (4 * (1 + 2 * GROUPS) + 4 * GROUPS * K)


def framing_bytes(segments) -> int:
    """Bytes of `pack_lane_stream(segments)` that carry no symbol: the
    `fixed_overhead_bytes` and the 2 bytes that pad an odd count of a
    segment's words to a whole u32."""
    odd = sum(int(np.sum(seg.word_counts)) & 1 for seg in segments)
    return fixed_overhead_bytes(len(segments)) + 2 * odd


def unpack_lane_stream(buf: bytes):
    """Inverse of pack_lane_stream: a list of LaneStream segments. Checks
    the format word and every section's extent, so truncation or a layout
    mismatch raises ValueError."""
    buf = memoryview(buf)

    def take(pos: int, nbytes: int, what: str):
        if pos + nbytes > len(buf):
            raise ValueError(
                f"truncated lane stream: {what} needs {nbytes} bytes at "
                f"offset {pos}, have {len(buf) - pos}"
            )
        return buf[pos : pos + nbytes], pos + nbytes

    head, pos = take(0, 8, "header")
    fmt, count = (int(v) for v in np.frombuffer(head, "<u4"))
    if fmt != _format_word():
        raise ValueError(
            f"lane stream format word 0x{fmt:08x} does not match this "
            f"build's 0x{_format_word():08x} (magic/version/GROUPS/K)"
        )
    meta_w = 1 + 2 * GROUPS
    raw, pos = take(pos, 4 * meta_w * count, "segment metadata")
    meta = np.frombuffer(raw, "<u4").reshape(count, meta_w)
    segments = []
    for row in meta:
        n = int(row[0])
        wc = row[1 : 1 + GROUPS].astype(np.int64)
        sc = row[1 + GROUPS :].astype(np.int64)
        nw, ns = int(wc.sum()), int(sc.sum())
        raw, pos = take(pos, 4 * GROUPS * K, "init states")
        states = np.frombuffer(raw, "<u4").reshape(GROUPS, K)
        raw, pos = take(pos, 2 * nw, "word stream")
        words = np.frombuffer(raw, "<u2")
        _, pos = take(pos, (2 * nw) % 4, "alignment padding")
        raw, pos = take(pos, 4 * ns, "side channel")
        side = np.frombuffer(raw, "<i4")
        segments.append(LaneStream(words, wc, states, side, sc, n))
    if pos != len(buf):
        raise ValueError(
            f"lane stream has {len(buf) - pos} trailing bytes after the "
            "last segment"
        )
    return segments


# -- decoder banks --------------------------------------------------------------


def pack_word_banks(stream: LaneStream, rows: int) -> np.ndarray:
    """Per-group uint16 word streams -> (G*rows, K) int32 banks, two words
    per element (little-endian halves), zero-padded. `rows` must cover
    every group: words_rows_for(max(word_counts))."""
    out = np.zeros((GROUPS, rows * K * 2), np.uint16)
    wb = np.concatenate([[0], np.cumsum(stream.word_counts)])
    for g in range(GROUPS):
        w = stream.words[wb[g] : wb[g + 1]]
        out[g, : w.size] = w
    return out.reshape(-1).view("<i4").reshape(GROUPS * rows, K).copy()


def pad_side_banks(stream: LaneStream, rows: int) -> np.ndarray:
    """Per-group int32 side channels -> (G*rows, K) int32 banks."""
    out = np.zeros((GROUPS, rows * K), np.int32)
    sb = np.concatenate([[0], np.cumsum(stream.side_counts)])
    for g in range(GROUPS):
        s = stream.side[sb[g] : sb[g + 1]]
        out[g, : s.size] = s
    return out.reshape(GROUPS * rows, K)


def flat_banks(segments, wr: int, sr: int):
    """Compact upload form of every segment's decoder inputs: one flat
    int32 buffer holding, per segment, each group's word pairs (two LE
    uint16 words per int32, `pack_word_banks`'s element layout), side
    values and init states back to back, plus an (n_seg, 3, GROUPS) int32
    offset table (word / side / state start, in int32 elements). The fused
    decompress rebuilds the kernel's padded (G*rows, K) banks on the device
    by gather, so the upload is ~stream bytes instead of bucket-padded
    banks. The buffer ends with max(wr, sr)*K zeros so every fixed-size
    window stays in bounds; window tails read the next group's data, which
    the decoder never consumes (it stops at each group's written count).
    """
    chunks = []
    offs = np.zeros((len(segments), 3, GROUPS), np.int64)
    pos = 0
    for j, seg in enumerate(segments):
        wb = np.concatenate([[0], np.cumsum(seg.word_counts)])
        sb = np.concatenate([[0], np.cumsum(seg.side_counts)])
        for g in range(GROUPS):
            w = np.asarray(seg.words[wb[g] : wb[g + 1]], "<u2")
            pad = np.zeros((w.size + 1) // 2 * 2, "<u2")
            pad[: w.size] = w
            wi = pad.view("<i4")
            chunks.append(wi)
            offs[j, 0, g] = pos
            pos += wi.size
        for g in range(GROUPS):
            sd = np.asarray(seg.side[sb[g] : sb[g + 1]], np.int32)
            chunks.append(sd)
            offs[j, 1, g] = pos
            pos += sd.size
        st = np.ascontiguousarray(seg.states, "<u4").view(np.int32)
        for g in range(GROUPS):
            offs[j, 2, g] = pos + g * K
        chunks.append(st.reshape(-1))
        pos += st.size
    chunks.append(np.zeros(max(wr, sr) * K, np.int32))
    return np.concatenate(chunks), offs.astype(np.int32)


def words_rows_for(n_words: int) -> int:
    return (int(n_words) + 2 * K - 1) // (2 * K) + 2


def side_rows_for(n_side: int) -> int:
    return (int(n_side) + K - 1) // K + 2


def states_tensor(stream: LaneStream, device) -> torch.Tensor:
    """(G, K) uint32 init states as the bit-identical int32 tensor the
    decoder takes (torch has no general uint32 arithmetic)."""
    st = np.ascontiguousarray(stream.states, "<u4").view(np.int32)
    return torch.from_numpy(st.copy()).to(device)


def table_tensors(tables: LaneTables, device):
    """(cdf, lengths, offsets) int32 tensors on `device`."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
        for a in (tables.cdf, tables.lengths, tables.offsets)
    )


# -- device decoder (kernel B2) ---------------------------------------------------


def lane_decode_plain(idx, words, side, states, cdf, lengths, offsets, n: int):
    """Plain PyTorch version of kernel B2, with the kernel's signature and
    arithmetic: all G*K lanes advance one row per step; in-row ranks are
    exclusive cumulative sums of the renorm / escape masks. Reads past a
    bank's end give 0, as in the kernel."""
    dev = idx.device
    tg = rows_per_group(n)
    G = states.shape[0]
    wcap = words.numel() // G  # int32 word pairs per group
    scap = side.numel() // G   # side values per group
    idx_p = torch.zeros(G * tg * K, dtype=torch.int64, device=dev)
    idx_p[:n] = idx.reshape(-1).to(torch.int64)
    idx_p = idx_p.reshape(G, tg, K).clamp_(0, cdf.shape[0] - 1)
    pairs = words.reshape(G, wcap).to(torch.int64) & 0xFFFFFFFF
    w16 = torch.stack([pairs & 0xFFFF, pairs >> 16], -1).reshape(G, -1)
    w16 = torch.cat([w16, torch.zeros(G, 1, dtype=torch.int64, device=dev)], 1)
    sbank = side.reshape(G, scap).to(torch.int64)
    sbank = torch.cat([sbank, torch.zeros(G, 1, dtype=torch.int64, device=dev)], 1)
    cdf64 = cdf.to(torch.int64)
    lens = lengths.to(torch.int64)
    offs = offsets.to(torch.int64)
    state = states.reshape(G, K).to(torch.int64) & 0xFFFFFFFF
    wpos = torch.zeros(G, 1, dtype=torch.int64, device=dev)
    spos = torch.zeros(G, 1, dtype=torch.int64, device=dev)
    out = torch.empty(G, tg, K, dtype=torch.int64, device=dev)
    for t in range(tg):
        r = idx_p[:, t]                                  # (G, K)
        row = cdf64[r]                                   # (G, K, W)
        slot = state & 0xFFFF
        le = row <= slot[..., None]
        j = le[..., 1:].sum(-1)                          # largest cdf[j] <= slot
        cum = row.gather(-1, j[..., None])[..., 0]
        nxt = row.gather(-1, (j + 1)[..., None])[..., 0].clamp(max=RANS_L)
        state = (nxt - cum) * (state >> PRECISION) + slot - cum
        m = state < RANS_L
        wr = wpos + torch.cumsum(m, 1) - m.to(torch.int64)
        wr = wr.clamp(max=w16.shape[1] - 1)
        word = w16.gather(1, wr)
        state = torch.where(m, (state << PRECISION) | word, state)
        wpos = wpos + m.sum(1, keepdim=True)
        esc = j == lens[r] - 2
        sr = spos + torch.cumsum(esc, 1) - esc.to(torch.int64)
        sr = sr.clamp(max=sbank.shape[1] - 1)
        out[:, t] = torch.where(esc, sbank.gather(1, sr), j + offs[r])
        spos = spos + esc.sum(1, keepdim=True)
    return out.reshape(-1)[:n].to(torch.int32)


def lane_decode(idx, words, side, states, cdf, lengths, offsets, n: int):
    """Decode one segment's n symbols -> (n,) int32.

    idx: (n,) int32 CDF-row indexes in stream order (NHWC C-order of the
    slice); words: (G*rows, K) int32 banks (`pack_word_banks`); side:
    (G*rows_s, K) int32 (`pad_side_banks`); states: (G, K) int32 holding
    the u32 init states (`states_tensor`); cdf/lengths/offsets: int32
    `table_tensors`. On CUDA tensors this launches kernel B2; on CPU
    tensors it runs `lane_decode_plain`."""
    if idx.device.type == "cpu":
        return lane_decode_plain(
            idx, words, side, states, cdf, lengths, offsets, n
        )
    if idx.device.type != "cuda":
        raise ValueError(f"lane_decode runs on cuda or cpu, not {idx.device}")
    dev = idx.device
    R, W = cdf.shape
    for name, t, shape in (
        ("idx", idx, (n,)), ("words", words, (None, K)),
        ("side", side, (None, K)), ("states", states, (None, K)),
        ("cdf", cdf, (R, W)), ("lengths", lengths, (R,)),
        ("offsets", offsets, (R,)),
    ):
        _native.check_operand(t, name, torch.int32, dev, shape)
    G = states.shape[0]
    if words.shape[0] % G or side.shape[0] % G:
        raise ValueError("word and side banks must hold one block per group")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _native.load("lanedecode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.stf_lane_decode(
            idx.data_ptr(), n, rows_per_group(n), G,
            words.data_ptr(), words.numel() // G,
            side.data_ptr(), side.numel() // G,
            states.data_ptr(), cdf.data_ptr(), R, W,
            lengths.data_ptr(), offsets.data_ptr(), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"lane_decode launch failed: {lib.stf_lane_decode_error(rc).decode()}"
        )
    _native.launch_counts["lane_decode"] += 1
    return out


def _declare(lib):
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.stf_lane_decode.restype = ctypes.c_int
    lib.stf_lane_decode.argtypes = [
        vp, i64, i64, i32, vp, i64, vp, i64, vp, vp, i32, i32, vp, vp, vp, vp,
    ]
    lib.stf_lane_decode_error.restype = ctypes.c_char_p
    lib.stf_lane_decode_error.argtypes = [ctypes.c_int]


_native.declare("lanedecode", _declare)


# -- device encoder (kernel B3) ---------------------------------------------------
#
# Symbols and indexes stay on the device (the codec walk makes them there);
# only stream-sized bytes cross to the host. Two passes per group: forward,
# escapes are compacted into the side channel at an ascending cursor, in the
# (row, lane-ascending) order of the host encoder and the decoder; backward,
# each row's renormalisation words land at a descending cursor,
# lane-ascending within the row, which reproduces the host encoder's stream
# byte for byte.


def encode_caps(n: int):
    """(tg, wcap_rows, scap_rows) for an n-symbol segment. wcap_rows has
    one pad row past the tg rows that can hold words; scap_rows bounds the
    side channel at ~1/8 escape rate: a group whose escapes reach past
    (scap_rows - 2)*K sets its overflow flag (counts[g, 2]) and the caller
    re-encodes the segment with the host encoder."""
    rows = (n + K - 1) // K
    tg = max((rows + GROUPS - 1) // GROUPS, 1)
    return tg, tg + 1, max(tg // 8, 2) + 4


def lane_encode_device_plain(sym, idx, cdf, lengths, offsets, n: int,
                             pad_sym: int):
    """Plain PyTorch version of kernel B3, with the kernel's signature and
    outputs: pass A vectorised (escape ranks are one cumulative sum), pass
    B one step per row over all G*K lanes, last row first."""
    dev = sym.device
    tg, wcap_rows, scap_rows = encode_caps(n)
    total = GROUPS * tg * K
    i64 = torch.int64

    def pad(a, fill):
        out = torch.full((total,), fill, dtype=i64, device=dev)
        out[:n] = a.reshape(-1).to(i64)
        return out.reshape(GROUPS, tg * K)

    v = pad(sym, pad_sym)
    r = pad(idx, 0).clamp_(0, cdf.shape[0] - 1)
    cdf64 = cdf.to(i64)
    lens = lengths.to(i64)[r]
    s = v - offsets.to(i64)[r]
    esc = (s < 0) | (s >= lens - 2)
    s = torch.where(esc, lens - 2, s)
    cum = cdf64[r, s]
    freq = cdf64[r, s + 1] - cum

    # pass A: a row writes its escapes while its start cursor is at most
    # (scap_rows - 2)*K, so every write stays inside the bank
    scap = scap_rows * K
    limit = (scap_rows - 2) * K
    ei = esc.to(i64)
    spos = torch.cumsum(ei, 1) - ei
    row_start = spos.reshape(GROUPS, tg, K)[:, :, :1].expand(-1, -1, K)
    keep = esc & (row_start.reshape(GROUPS, -1) <= limit)
    side = torch.zeros(GROUPS, scap + 1, dtype=i64, device=dev)
    side.scatter_(1, torch.where(keep, spos, scap), torch.where(keep, v, 0))
    n_side = ei.sum(1)

    # pass B: reverse interleaved rANS, back-filled word bank
    wcap = wcap_rows * K
    words = torch.zeros(GROUPS, wcap + 1, dtype=i64, device=dev)
    state = torch.full((GROUPS, K), RANS_L, dtype=i64, device=dev)
    cursor = torch.full((GROUPS, 1), tg * K, dtype=i64, device=dev)
    cum = cum.reshape(GROUPS, tg, K)
    freq = freq.reshape(GROUPS, tg, K)
    for t in range(tg - 1, -1, -1):
        f, c = freq[:, t], cum[:, t]
        m = state >= (f << PRECISION)
        mi = m.to(i64)
        n_emit = mi.sum(1, keepdim=True)
        pos = cursor - n_emit + torch.cumsum(mi, 1) - mi
        words.scatter_(1, torch.where(m, pos, wcap),
                       torch.where(m, state & 0xFFFF, 0))
        state = torch.where(m, state >> PRECISION, state)
        state = ((state // f) << PRECISION) + state % f + c
        cursor = cursor - n_emit

    counts = torch.zeros(GROUPS, 128, dtype=i64, device=dev)
    counts[:, 0] = tg * K - cursor[:, 0]
    counts[:, 1] = n_side
    counts[:, 2] = (n_side > limit).to(i64)
    return (
        words[:, :wcap].reshape(GROUPS * wcap_rows, K).to(torch.int32),
        side[:, :scap].reshape(GROUPS * scap_rows, K).to(torch.int32),
        torch.where(state >= 1 << 31, state - (1 << 32), state).to(torch.int32),
        counts.to(torch.int32),
    )


def lane_encode_device(sym, idx, cdf, lengths, offsets, n: int, pad_sym: int):
    """Encode an n-symbol segment on the device.

    sym/idx: (n,) int32 symbols and CDF-row indexes in stream order (NHWC
    C-order of the slice); cdf/lengths/offsets: int32 `table_tensors`;
    pad_sym: the tables' offsets[0], so padding encodes as the host
    encoder's does. Returns (words (G*wcap_rows, K) int32, one u16 per
    cell, each group's last word_counts[g] cells of its first tg rows
    being its stream; side (G*scap_rows, K) int32, filled from the front;
    states (G, K) int32 holding the u32 decoder init states; counts
    (G, 128) int32, columns 0..2 = [word count, side count, overflow]),
    as `encode_caps` sizes them; unused cells are 0. On CUDA tensors this
    launches kernel B3; on CPU tensors it runs `lane_encode_device_plain`.
    """
    if sym.device.type == "cpu":
        return lane_encode_device_plain(
            sym, idx, cdf, lengths, offsets, n, pad_sym
        )
    if sym.device.type != "cuda":
        raise ValueError(
            f"lane_encode_device runs on cuda or cpu, not {sym.device}"
        )
    dev = sym.device
    R, W = cdf.shape
    for name, t, shape in (
        ("sym", sym, (n,)), ("idx", idx, (n,)), ("cdf", cdf, (R, W)),
        ("lengths", lengths, (R,)), ("offsets", offsets, (R,)),
    ):
        _native.check_operand(t, name, torch.int32, dev, shape)
    tg, wcap_rows, scap_rows = encode_caps(n)
    words = torch.empty(GROUPS * wcap_rows, K, dtype=torch.int32, device=dev)
    side = torch.empty(GROUPS * scap_rows, K, dtype=torch.int32, device=dev)
    states = torch.empty(GROUPS, K, dtype=torch.int32, device=dev)
    counts = torch.empty(GROUPS, 128, dtype=torch.int32, device=dev)
    lib = _native.load("laneencode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.stf_lane_encode_device(
            sym.data_ptr(), idx.data_ptr(), n, tg, GROUPS, int(pad_sym),
            cdf.data_ptr(), R, W, lengths.data_ptr(), offsets.data_ptr(),
            words.data_ptr(), wcap_rows, side.data_ptr(), scap_rows,
            states.data_ptr(), counts.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "lane_encode_device launch failed: "
            f"{lib.stf_lane_encode_error(rc).decode()}"
        )
    _native.launch_counts["lane_encode"] += 1
    return words, side, states, counts


def assemble_from_tails(words_tail, side_tail, states_np, counts_np,
                        n: int) -> LaneStream:
    """Host side: the device encoder's outputs (as numpy) -> a LaneStream
    identical to lane_encode's. words_tail: (G, wb, K) int32, the last wb
    of each group's first tg word rows; side_tail: (G, sb, K) int32, the
    first sb side rows of each group. wb and sb need only cover the
    counts: the codec fetches bucketed tails, and
    `words.reshape(G, wcap_rows, K)[:, :tg]` with
    `side.reshape(G, scap_rows, K)` is the whole output."""
    words, side = [], []
    wb = words_tail.shape[1]
    for g in range(GROUPS):
        wc = int(counts_np[g, 0])
        sc = int(counts_np[g, 1])
        wflat = words_tail[g].reshape(-1)
        words.append(wflat[wb * K - wc:].astype(np.uint16))
        side.append(side_tail[g].reshape(-1)[:sc].astype(np.int32))
    return LaneStream(
        np.concatenate(words),
        np.asarray([w.size for w in words], np.int64),
        np.ascontiguousarray(states_np.astype(np.uint32)),
        np.concatenate(side) if side else np.empty(0, np.int32),
        np.asarray([s.size for s in side], np.int64),
        n,
    )


def _declare_encode(lib):
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.stf_lane_encode_device.restype = ctypes.c_int
    lib.stf_lane_encode_device.argtypes = [
        vp, vp, i64, i64, i32, i32, vp, i32, i32, vp, vp,
        vp, i64, vp, i64, vp, vp, vp,
    ]
    lib.stf_lane_encode_error.restype = ctypes.c_char_p
    lib.stf_lane_encode_error.argtypes = [ctypes.c_int]


_native.declare("laneencode", _declare_encode)


# -- layout pin (kernel B4) ------------------------------------------------------


class PinPlan(NamedTuple):
    """Kernel B4's path for one operand: the operand's geometry with its
    size-1 dims dropped and the dims whose strides chain merged (sizes and
    element strides, outermost first), and the bytes a thread moves at
    once on the packed path (the element size on the others)."""

    kind: str        # "packed", "transpose" or "general"
    sizes: tuple
    strides: tuple
    word: int


PIN_KINDS = ("packed", "transpose", "general")
_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
_INT32_MAX = 2**31 - 1


def pin_plan(shape, strides, elem_size: int, data_ptr: int) -> PinPlan:
    """Choose kernel B4's path from an operand's observable geometry:
    drop size-1 dims, merge neighbouring dims whose strides chain
    (stride[d] == stride[d + 1] * size[d + 1]), then
      * packed: one dim of stride 1, a flat copy;
      * transpose: inner stride not 1, the next dim stride 1 (an NHWC
        tensor viewed as NCHW);
      * general: anything else (a crop, a stride-0 dim, a doubly permuted
        view, or a grid the transpose cannot launch)."""
    merged = []
    for n, s in zip(shape, strides):
        if n == 1:
            continue
        if merged and merged[-1][1] == s * n:
            merged[-1] = (merged[-1][0] * n, s)
        else:
            merged.append((n, s))
    sizes, strides = (tuple(a) for a in zip(*merged)) if merged else ((1,), (1,))
    kind, word = "general", elem_size
    if len(sizes) == 1 and strides[0] == 1:
        kind = "packed"
        while word < 16 and data_ptr % (2 * word) == 0:
            word *= 2
    elif (len(sizes) >= 2 and strides[-1] != 1 and strides[-2] == 1
          and 0 not in strides and -(-sizes[-2] // 32) <= _GRID_YZ
          and sizes[-1] <= _INT32_MAX and math.prod(sizes[:-2]) <= _GRID_YZ):
        kind = "transpose"
    return PinPlan(kind, sizes, strides, word)


def layout_pin_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: a densely packed row-major copy
    with the same bits."""
    return x.clone(memory_format=torch.contiguous_format)


def layout_pin(x: torch.Tensor) -> torch.Tensor:
    """Bit-exact copy of a strided tensor of up to 4 dims with 1-, 2- or
    4-byte elements into a fresh densely packed row-major tensor. The
    fused decompress routes every operand of its walk through it, at the
    positions where the JAX codec's fused walk pins them, so each
    operand has one canonical layout in the captured graph and in the
    eager walk. On CUDA tensors this launches kernel B4 along the path
    `pin_plan` chooses (counted in `launch_counts["layout_pin"]` and
    `["layout_pin_<kind>"]`); on CPU tensors it runs `layout_pin_plain`."""
    if x.device.type == "cpu":
        return layout_pin_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"layout_pin runs on cuda or cpu, not {x.device}")
    if x.dim() > 4:
        raise ValueError(f"layout_pin takes up to 4 dims, got {x.dim()}")
    size = x.element_size()
    if size not in (1, 2, 4):
        raise TypeError(f"layout_pin takes 1/2/4-byte elements, not {x.dtype}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("layout_pin needs a 16-byte aligned output")
    plan = pin_plan(x.shape, x.stride(), size, x.data_ptr())
    pad = 4 - len(plan.sizes)
    sizes = (ctypes.c_int64 * 4)(*((1,) * pad + plan.sizes))
    strides = (ctypes.c_int64 * 4)(*((0,) * pad + plan.strides))
    lib = _native.load("layoutpin")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.stf_layout_pin(
            x.data_ptr(), out.data_ptr(), PIN_KINDS.index(plan.kind), size,
            plan.word, sizes, strides, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"layout_pin launch failed ({plan}): "
            f"{lib.stf_layout_pin_error(rc).decode()}"
        )
    _native.launch_counts["layout_pin"] += 1
    _native.launch_counts[f"layout_pin_{plan.kind}"] += 1
    return out


def _declare_pin(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    arr = ctypes.POINTER(ctypes.c_int64)
    lib.stf_layout_pin.restype = ctypes.c_int
    lib.stf_layout_pin.argtypes = [vp, vp, ci, ci, ci, arr, arr, vp]
    lib.stf_layout_pin_error.restype = ctypes.c_char_p
    lib.stf_layout_pin_error.argtypes = [ctypes.c_int]


_native.declare("layoutpin", _declare_pin)
