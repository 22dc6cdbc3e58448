// stf_tpu_torch native entropy-coding core, the port's own copy of
// stf_tpu/ans/csrc/rans_coder.cpp (streams stay byte-identical with it):
// 64-bit rANS encoder/decoder plus the PMF -> quantized-CDF conversion,
// exported through a plain C ABI consumed from Python via ctypes (no
// pybind11 dependency).
//
// Behavioral contract (so checkpoints/bitstreams interoperate at the symbol
// level with the reference coder, compressai/cpp_exts/):
//   * 16-bit coding precision; per-row integer CDF tables where
//     cdf[0] == 0, cdf[len-1] == 1 << 16, strictly increasing.
//   * per-symbol: row selected by an index array; symbol value shifted by a
//     per-row offset; values outside [0, max_value) escape into bypass mode:
//     the escape symbol is the last bin, followed by a count of 4-bit chunks
//     written in saturating base-15 unary, then the chunks of the zig-zag
//     mapped raw value (negative v -> -2v-1, overflow v -> 2(v-max_value)).
//   * streams are built of 32-bit words, written backwards by the encoder and
//     read forwards by the decoder; the final 64-bit state is flushed as two
//     little words (low, high).
//
// All hot paths take raw pointers into NumPy buffers, avoiding the reference's
// per-call Python list marshalling (its known bottleneck: entropy_models.py
// .tolist() round-trips).

#include <algorithm>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kPrecision = 16;
constexpr uint32_t kBypassBits = 4;
constexpr uint32_t kMaxBypassVal = (1u << kBypassBits) - 1;  // 15
constexpr uint64_t kStateLow = 1ull << 31;

// ---------------------------------------------------------------------------
// rANS primitive (Duda's range-variant asymmetric numeral system, 64-bit
// state, 32-bit word renormalization).
// ---------------------------------------------------------------------------

struct RansEncState {
  uint64_t x = kStateLow;

  // Push one symbol with cumulative start `start` and frequency `freq`
  // (frequencies sum to 1 << bits). Words are emitted at *--ptr.
  inline void put(uint32_t **ptr, uint32_t start, uint32_t freq,
                  uint32_t bits) {
    const uint64_t x_max = ((kStateLow >> bits) << 32) * freq;
    if (x >= x_max) {
      *(--(*ptr)) = static_cast<uint32_t>(x);
      x >>= 32;
    }
    x = ((x / freq) << bits) + (x % freq) + start;
  }

  // Push `nbits` raw bits (bypass lane). Equivalent to a symbol with
  // start=val, freq = 1 << (16 - nbits) under 16-bit precision, but with the
  // division strength-reduced to shifts.
  inline void put_bits(uint32_t **ptr, uint32_t val, uint32_t nbits) {
    const uint32_t freq = 1u << (16 - nbits);
    const uint64_t x_max = ((kStateLow >> 16) << 32) * freq;
    if (x >= x_max) {
      *(--(*ptr)) = static_cast<uint32_t>(x);
      x >>= 32;
    }
    x = (x << nbits) | val;
  }

  inline void flush(uint32_t **ptr) {
    *ptr -= 2;
    (*ptr)[0] = static_cast<uint32_t>(x);
    (*ptr)[1] = static_cast<uint32_t>(x >> 32);
  }
};

struct RansDecState {
  uint64_t x = 0;
  const uint32_t *end = nullptr;  // one past the last stream word

  // Renormalization word fetch, bounded: a truncated or corrupt stream
  // (the one untrusted input of the decode path) zero-fills past the end
  // instead of reading out of bounds — decode stays deterministic and
  // in-bounds, producing garbage symbols the caller's checks (hash
  // guards, PSNR) catch. Valid streams never hit the bound, so behavior
  // on well-formed input is bit-identical.
  inline uint32_t next_word(const uint32_t **ptr) {
    return (*ptr < end) ? *(*ptr)++ : 0u;
  }

  inline void init(const uint32_t **ptr, const uint32_t *stream_end) {
    end = stream_end;
    x = static_cast<uint64_t>((*ptr)[0]) |
        (static_cast<uint64_t>((*ptr)[1]) << 32);
    *ptr += 2;
  }

  inline uint32_t peek(uint32_t bits) const {
    return static_cast<uint32_t>(x & ((1u << bits) - 1));
  }

  inline void advance(const uint32_t **ptr, uint32_t start, uint32_t freq,
                      uint32_t bits) {
    const uint64_t mask = (1ull << bits) - 1;
    x = freq * (x >> bits) + (x & mask) - start;
    if (x < kStateLow) {
      x = (x << 32) | next_word(ptr);
    }
  }

  inline uint32_t get_bits(const uint32_t **ptr, uint32_t nbits) {
    const uint32_t val = static_cast<uint32_t>(x & ((1u << nbits) - 1));
    x >>= nbits;
    if (x < kStateLow) {
      x = (x << 32) | next_word(ptr);
    }
    return val;
  }
};

// One buffered (start, range, bypass) triple; encode is two-phase because
// rANS must write symbols in reverse order.
struct BufferedSym {
  uint16_t start;
  uint16_t range;
  uint16_t bypass;
};

struct CdfView {
  const int32_t *cdfs;         // [rows, stride] row-major quantized CDFs
  int64_t stride;
  const int32_t *cdf_lengths;  // [rows]
  const int32_t *offsets;      // [rows]

  inline const int32_t *row(int32_t idx) const { return cdfs + idx * stride; }
};

void buffer_symbols(std::vector<BufferedSym> &syms, const int32_t *symbols,
                    const int32_t *indexes, int64_t n, const CdfView &t) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t cdf_idx = indexes[i];
    const int32_t *cdf = t.row(cdf_idx);
    const int32_t max_value = t.cdf_lengths[cdf_idx] - 2;

    int32_t value = symbols[i] - t.offsets[cdf_idx];

    uint32_t raw_val = 0;
    if (value < 0) {
      raw_val = static_cast<uint32_t>(-2 * value - 1);
      value = max_value;
    } else if (value >= max_value) {
      raw_val = static_cast<uint32_t>(2 * (value - max_value));
      value = max_value;
    }

    syms.push_back({static_cast<uint16_t>(cdf[value]),
                    static_cast<uint16_t>(cdf[value + 1] - cdf[value]),
                    uint16_t{0}});

    if (value == max_value) {
      // Count of 4-bit chunks, saturating base-15 unary.
      int32_t n_bypass = 0;
      while ((raw_val >> (n_bypass * kBypassBits)) != 0) ++n_bypass;

      int32_t val = n_bypass;
      while (val >= static_cast<int32_t>(kMaxBypassVal)) {
        syms.push_back({static_cast<uint16_t>(kMaxBypassVal), 0, 1});
        val -= kMaxBypassVal;
      }
      syms.push_back({static_cast<uint16_t>(val), 0, 1});

      for (int32_t j = 0; j < n_bypass; ++j) {
        const uint32_t chunk = (raw_val >> (j * kBypassBits)) & kMaxBypassVal;
        syms.push_back({static_cast<uint16_t>(chunk), 0, 1});
      }
    }
  }
}

// Encode the buffered symbols (in reverse) into `out` (capacity `out_cap`
// bytes). Returns the number of bytes produced, or -1 if out_cap is too
// small. The stream is left-aligned in `out`.
int64_t flush_syms(std::vector<BufferedSym> &syms, uint8_t *out,
                   int64_t out_cap) {
  const size_t n_words = syms.size() + 2;
  if (out_cap < 0 || static_cast<size_t>(out_cap) < n_words * 4) return -1;

  std::vector<uint32_t> buf(n_words);
  uint32_t *ptr = buf.data() + buf.size();

  RansEncState rans;
  for (size_t k = syms.size(); k-- > 0;) {
    const BufferedSym &s = syms[k];
    if (!s.bypass) {
      rans.put(&ptr, s.start, s.range, kPrecision);
    } else {
      rans.put_bits(&ptr, s.start, kBypassBits);
    }
  }
  rans.flush(&ptr);

  const int64_t nbytes =
      static_cast<int64_t>(buf.data() + buf.size() - ptr) * 4;
  std::memcpy(out, ptr, static_cast<size_t>(nbytes));
  syms.clear();
  return nbytes;
}

// Symbol-layer decode shared by BOTH host bit layers (rANS and the range
// coder): row select, linear CDF scan, escape -> bypass chunks with
// saturating base-15 unary counts, zig-zag raw-value reassembly. The bit
// layer is abstracted behind `Dec` (peek_cum / consume / bypass_bits) so the
// protocol cannot drift between backends.
template <class Dec>
int64_t decode_symbols_t(Dec &dec, const int32_t *indexes, int64_t n,
                         const CdfView &t, int32_t *out) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t cdf_idx = indexes[i];
    const int32_t *cdf = t.row(cdf_idx);
    const int32_t cdf_len = t.cdf_lengths[cdf_idx];
    const int32_t max_value = cdf_len - 2;

    const uint32_t cum = dec.peek_cum();

    // CDF rows are small (tens of entries): linear scan beats binary search
    // in practice and matches the reference's lookup semantics.
    int32_t s = 0;
    while (s + 1 < cdf_len && static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;

    dec.consume(cdf[s], cdf[s + 1] - cdf[s]);

    int32_t value = s;
    if (value == max_value) {
      uint32_t val = dec.bypass_bits();
      int32_t n_bypass = static_cast<int32_t>(val);
      while (val == kMaxBypassVal) {
        val = dec.bypass_bits();
        n_bypass += static_cast<int32_t>(val);
      }
      uint32_t raw_val = 0;
      for (int32_t j = 0; j < n_bypass; ++j) {
        const uint32_t chunk = dec.bypass_bits();
        // A well-formed stream carries at most 8 chunks (raw_val is
        // 32-bit); a corrupt one can claim more — consume them to stay
        // deterministic but don't shift past the word (UB).
        if (j < 8) raw_val |= chunk << (j * kBypassBits);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1u) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }

    out[i] = value + t.offsets[cdf_idx];
  }
  return n;
}

// rANS bit-layer adapter for decode_symbols_t.
struct RansSymDec {
  RansDecState &rans;
  const uint32_t **ptr;
  inline uint32_t peek_cum() { return rans.peek(kPrecision); }
  inline void consume(uint32_t start, uint32_t freq) {
    rans.advance(ptr, start, freq, kPrecision);
  }
  inline uint32_t bypass_bits() { return rans.get_bits(ptr, kBypassBits); }
};

int64_t decode_symbols(RansDecState &rans, const uint32_t **ptr,
                       const int32_t *indexes, int64_t n, const CdfView &t,
                       int32_t *out) {
  RansSymDec dec{rans, ptr};
  return decode_symbols_t(dec, indexes, n, t, out);
}

// ---------------------------------------------------------------------------
// Range coder (carry-propagating, byte-wise renormalization in the classic
// LZMA/7-zip style) — the alternative host backend the reference exposes as
// "rangecoder" (`compressai/__init__.py:22-62`, via the `range_coder` pip
// package). Same symbol-level protocol as the rANS backend (shared
// buffer_symbols / decode_symbols_t); only the bit layer differs. Bytes are
// written FORWARD, so the decoder consumes symbols in encode order and no
// reverse buffering is fundamentally required (the buffered encoder keeps
// the same two-phase API as rANS for interface parity).
// ---------------------------------------------------------------------------

constexpr uint32_t kRcTop = 1u << 24;

struct RcEncState {
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  int64_t cache_size = 1;
  std::vector<uint8_t> out;

  inline void shift_low() {
    if (static_cast<uint32_t>(low) < 0xFF000000u || (low >> 32) != 0) {
      uint8_t b = cache;
      const uint8_t carry = static_cast<uint8_t>(low >> 32);
      do {
        out.push_back(static_cast<uint8_t>(b + carry));
        b = 0xFF;
      } while (--cache_size != 0);
      cache = static_cast<uint8_t>(static_cast<uint32_t>(low) >> 24);
    }
    ++cache_size;
    // The departing byte (bits 24..31) lives in `cache` (or is a pending
    // 0xFF tracked by cache_size); low keeps only bits 0..23, so any later
    // overflow past 2^32 is exactly a +1 carry into the emitted bytes.
    low = (low & 0x00FFFFFFull) << 8;
  }

  // Encode a symbol spanning [cum, cum+freq) of a 2^bits total.
  inline void encode(uint32_t cum, uint32_t freq, uint32_t bits) {
    range >>= bits;
    low += static_cast<uint64_t>(cum) * range;
    range *= freq;
    while (range < kRcTop) {
      range <<= 8;
      shift_low();
    }
  }

  inline void finish() {
    for (int i = 0; i < 5; ++i) shift_low();
  }
};

struct RcDecState {
  const uint8_t *p = nullptr;
  const uint8_t *end = nullptr;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  inline uint8_t next() { return p < end ? *p++ : 0; }

  inline void init(const uint8_t *stream, int64_t len) {
    p = stream;
    end = stream + len;
    range = 0xFFFFFFFFu;
    code = 0;
    // 5 bytes: the encoder's first shift_low emits the initial zero cache.
    for (int i = 0; i < 5; ++i) code = (code << 8) | next();
  }

  // Returns the cumulative-frequency threshold for a 2^bits total and
  // commits range /= total (consume() must follow with the chosen bin).
  inline uint32_t threshold(uint32_t bits) {
    range >>= bits;
    const uint32_t v = code / range;
    const uint32_t cap = (1u << bits) - 1;
    return v < cap ? v : cap;
  }

  inline void consume(uint32_t cum, uint32_t freq) {
    code -= cum * range;
    range *= freq;
    while (range < kRcTop) {
      code = (code << 8) | next();
      range <<= 8;
    }
  }
};

// Range-coder bit-layer adapter for decode_symbols_t.
struct RcSymDec {
  RcDecState &rc;
  inline uint32_t peek_cum() { return rc.threshold(kPrecision); }
  inline void consume(uint32_t start, uint32_t freq) {
    rc.consume(start, freq);
  }
  inline uint32_t bypass_bits() {
    const uint32_t v = rc.threshold(kBypassBits);
    rc.consume(v, 1);
    return v;
  }
};

// Forward-encode the buffered symbol triples with the range coder; same
// capacity contract as flush_syms (caller sizes via stf_encoder_bound,
// which over-covers the range coder's <= 2 B/symbol worst case).
int64_t flush_syms_rc(std::vector<BufferedSym> &syms, uint8_t *out,
                      int64_t out_cap) {
  RcEncState rc;
  rc.out.reserve(syms.size() * 2 + 8);
  for (const BufferedSym &s : syms) {
    if (!s.bypass) {
      rc.encode(s.start, s.range, kPrecision);
    } else {
      rc.encode(s.start, 1, kBypassBits);
    }
  }
  rc.finish();
  if (out_cap < static_cast<int64_t>(rc.out.size())) return -1;
  std::memcpy(out, rc.out.data(), rc.out.size());
  syms.clear();
  return static_cast<int64_t>(rc.out.size());
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// --- buffered encoder -------------------------------------------------------

struct StfBufferedEncoder {
  std::vector<BufferedSym> syms;
};

StfBufferedEncoder *stf_encoder_new() { return new StfBufferedEncoder(); }

void stf_encoder_free(StfBufferedEncoder *enc) { delete enc; }

// Buffer `n` symbols; may be called repeatedly (e.g. once per AR slice).
void stf_encoder_buffer(StfBufferedEncoder *enc, const int32_t *symbols,
                        const int32_t *indexes, int64_t n,
                        const int32_t *cdfs, int64_t cdf_stride,
                        const int32_t *cdf_lengths, const int32_t *offsets) {
  CdfView t{cdfs, cdf_stride, cdf_lengths, offsets};
  buffer_symbols(enc->syms, symbols, indexes, n, t);
}

// Encode everything buffered so far; clears the buffer. Returns bytes
// written into `out`, or -1 if `out_cap` is insufficient (caller should
// retry with >= stf_encoder_bound(enc)).
int64_t stf_encoder_flush(StfBufferedEncoder *enc, uint8_t *out,
                          int64_t out_cap) {
  return flush_syms(enc->syms, out, out_cap);
}

// Worst-case flush size in bytes for the current buffer.
int64_t stf_encoder_bound(const StfBufferedEncoder *enc) {
  return static_cast<int64_t>(enc->syms.size() + 2) * 4;
}

// --- stateless decode -------------------------------------------------------

int64_t stf_decode_with_indexes(const uint8_t *stream, int64_t stream_len,
                                const int32_t *indexes, int64_t n,
                                const int32_t *cdfs, int64_t cdf_stride,
                                const int32_t *cdf_lengths,
                                const int32_t *offsets, int32_t *out) {
  if (stream_len < 8 || (stream_len % 4) != 0) return -1;
  CdfView t{cdfs, cdf_stride, cdf_lengths, offsets};
  const uint32_t *ptr = reinterpret_cast<const uint32_t *>(stream);
  RansDecState rans;
  rans.init(&ptr, ptr + stream_len / 4);
  return decode_symbols(rans, &ptr, indexes, n, t, out);
}

// --- streaming decoder (for channel-autoregressive decode) ------------------

struct StfStreamDecoder {
  std::vector<uint8_t> stream;
  const uint32_t *ptr = nullptr;
  RansDecState rans;
};

StfStreamDecoder *stf_decoder_new() { return new StfStreamDecoder(); }

void stf_decoder_free(StfStreamDecoder *dec) { delete dec; }

int32_t stf_decoder_set_stream(StfStreamDecoder *dec, const uint8_t *stream,
                               int64_t stream_len) {
  if (stream_len < 8 || (stream_len % 4) != 0) return -1;
  dec->stream.assign(stream, stream + stream_len);
  dec->ptr = reinterpret_cast<const uint32_t *>(dec->stream.data());
  dec->rans.init(&dec->ptr, dec->ptr + stream_len / 4);
  return 0;
}

int64_t stf_decoder_decode_stream(StfStreamDecoder *dec,
                                  const int32_t *indexes, int64_t n,
                                  const int32_t *cdfs, int64_t cdf_stride,
                                  const int32_t *cdf_lengths,
                                  const int32_t *offsets, int32_t *out) {
  if (dec->ptr == nullptr) return -1;
  CdfView t{cdfs, cdf_stride, cdf_lengths, offsets};
  return decode_symbols(dec->rans, &dec->ptr, indexes, n, t, out);
}

// --- lane coder encode ------------------------------------------------------

// Host-side encoder for the lane coder (`stf_tpu_torch/ans/lane_coder.py`):
// `groups` independent segments of `tg` rows x `lanes` interleaved rANS32
// lanes with 16-bit renormalization. Bit-exact with lane_coder.lane_encode's
// NumPy reference (same buffer layout: per group, words are consumed by the
// forward decoder in (row, lane-ascending) order, so the reverse-running
// encoder emits in (row-descending, lane-descending) order into a
// backward-filled buffer). Out-of-window symbols encode the escape slot and
// push their raw value onto the per-group side channel in FORWARD order.
//
// symbols/indexes: [groups * tg * lanes], already padded by the caller.
// words_out capacity must be >= groups*tg*lanes (one word max per symbol);
// side_out capacity likewise. Returns 0, or -1 on a bad table index.
int32_t stf_lane_encode(const int32_t *symbols, const int32_t *indexes,
                        int64_t tg, int32_t groups, int32_t lanes,
                        const int32_t *cdfs, int64_t cdf_stride,
                        const int32_t *cdf_lengths, const int32_t *offsets,
                        uint16_t *words_out, int64_t *word_counts,
                        uint32_t *states_out, int32_t *side_out,
                        int64_t *side_counts) {
  const int64_t gsz = tg * lanes;
  CdfView t{cdfs, cdf_stride, cdf_lengths, offsets};

  std::vector<uint16_t> cum_buf(static_cast<size_t>(gsz));
  std::vector<uint16_t> freq_buf(static_cast<size_t>(gsz));
  std::vector<uint16_t> scratch(static_cast<size_t>(gsz));
  std::vector<uint64_t> state(static_cast<size_t>(lanes));

  uint16_t *wcursor = words_out;
  int32_t *scursor = side_out;

  for (int32_t g = 0; g < groups; ++g) {
    const int32_t *sym = symbols + g * gsz;
    const int32_t *idx = indexes + g * gsz;

    // forward pass: slot -> (cum, freq); escapes to the side channel
    int64_t n_side = 0;
    for (int64_t i = 0; i < gsz; ++i) {
      const int32_t cdf_idx = idx[i];
      if (cdf_idx < 0) return -1;
      const int32_t *cdf = t.row(cdf_idx);
      const int32_t max_s = t.cdf_lengths[cdf_idx] - 2;  // escape slot
      int32_t s = sym[i] - t.offsets[cdf_idx];
      if (s < 0 || s >= max_s) {
        scursor[n_side++] = sym[i];
        s = max_s;
      }
      cum_buf[i] = static_cast<uint16_t>(cdf[s]);
      freq_buf[i] = static_cast<uint16_t>(cdf[s + 1] - cdf[s]);
    }
    side_counts[g] = n_side;
    scursor += n_side;

    // reverse pass: interleaved rANS32, backward-filled word buffer
    for (int32_t k = 0; k < lanes; ++k) state[k] = 1ull << kPrecision;
    uint16_t *wptr = scratch.data() + gsz;
    for (int64_t tr = tg - 1; tr >= 0; --tr) {
      const int64_t base = tr * lanes;
      for (int32_t k = lanes - 1; k >= 0; --k) {
        const uint64_t f = freq_buf[base + k];
        const uint64_t c = cum_buf[base + k];
        uint64_t x = state[k];
        if (x >= (f << kPrecision)) {
          *--wptr = static_cast<uint16_t>(x & 0xFFFF);
          x >>= kPrecision;
        }
        state[k] = ((x / f) << kPrecision) + c + (x % f);
      }
    }
    const int64_t n_words = scratch.data() + gsz - wptr;
    std::memcpy(wcursor, wptr, static_cast<size_t>(n_words) * 2);
    word_counts[g] = n_words;
    wcursor += n_words;
    for (int32_t k = 0; k < lanes; ++k) {
      states_out[g * lanes + k] = static_cast<uint32_t>(state[k]);
    }
  }
  return 0;
}

// --- range coder backend ------------------------------------------------------

// The buffered range-coder encoder reuses StfBufferedEncoder (identical
// symbol-translation phase); only the flush differs. stf_encoder_bound's
// (n+2)*4-byte capacity over-covers the range coder's <= ~2 B/symbol.
int64_t stf_rc_encoder_flush(StfBufferedEncoder *enc, uint8_t *out,
                             int64_t out_cap) {
  return flush_syms_rc(enc->syms, out, out_cap);
}

int64_t stf_rc_decode_with_indexes(const uint8_t *stream, int64_t stream_len,
                                   const int32_t *indexes, int64_t n,
                                   const int32_t *cdfs, int64_t cdf_stride,
                                   const int32_t *cdf_lengths,
                                   const int32_t *offsets, int32_t *out) {
  if (stream_len < 5) return -1;
  CdfView t{cdfs, cdf_stride, cdf_lengths, offsets};
  RcDecState rc;
  rc.init(stream, stream_len);
  RcSymDec dec{rc};
  return decode_symbols_t(dec, indexes, n, t, out);
}

struct StfRcStreamDecoder {
  std::vector<uint8_t> stream;
  RcDecState rc;
  bool ready = false;
};

StfRcStreamDecoder *stf_rc_decoder_new() { return new StfRcStreamDecoder(); }

void stf_rc_decoder_free(StfRcStreamDecoder *dec) { delete dec; }

int32_t stf_rc_decoder_set_stream(StfRcStreamDecoder *dec,
                                  const uint8_t *stream, int64_t stream_len) {
  if (stream_len < 5) return -1;
  dec->stream.assign(stream, stream + stream_len);
  dec->rc.init(dec->stream.data(), stream_len);
  dec->ready = true;
  return 0;
}

int64_t stf_rc_decoder_decode_stream(StfRcStreamDecoder *dec,
                                     const int32_t *indexes, int64_t n,
                                     const int32_t *cdfs, int64_t cdf_stride,
                                     const int32_t *cdf_lengths,
                                     const int32_t *offsets, int32_t *out) {
  if (!dec->ready) return -1;
  CdfView t{cdfs, cdf_stride, cdf_lengths, offsets};
  RcSymDec d{dec->rc};
  return decode_symbols_t(d, indexes, n, t, out);
}

// --- PMF -> quantized CDF ----------------------------------------------------

// Quantize a PMF of `n` float probabilities to an integer CDF of n+1 entries
// summing to 1 << precision with no zero-width bins. Same algorithm as the
// reference's CDF routine (`cpp_exts/ops/ops.cpp:24-81`): round to the grid,
// rescale, prefix-sum, then repair empty bins by stealing one count at a time
// from the smallest bin with frequency > 1. Returns 0 on success.
int32_t stf_pmf_to_quantized_cdf(const float *pmf, int64_t n,
                                 int32_t precision, uint32_t *cdf_out) {
  const int64_t m = n + 1;  // cdf entries
  cdf_out[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    float p = pmf[i];
    if (!(p >= 0.f)) p = 0.f;  // clamp NaN/negative
    cdf_out[i + 1] =
        static_cast<uint32_t>(std::lround(static_cast<double>(p) *
                                          (1 << precision)));
  }

  uint64_t total = 0;
  for (int64_t i = 0; i < m; ++i) total += cdf_out[i];
  if (total == 0) {
    // Degenerate PMF: fall back to uniform frequencies.
    for (int64_t i = 0; i < n; ++i) cdf_out[i + 1] = 1;
    total = static_cast<uint64_t>(n);
  }

  for (int64_t i = 0; i < m; ++i) {
    cdf_out[i] = static_cast<uint32_t>(
        (static_cast<uint64_t>(1u << precision) * cdf_out[i]) / total);
  }

  for (int64_t i = 1; i < m; ++i) cdf_out[i] += cdf_out[i - 1];
  cdf_out[m - 1] = 1u << precision;

  for (int64_t i = 0; i < m - 1; ++i) {
    if (cdf_out[i] == cdf_out[i + 1]) {
      uint32_t best_freq = ~0u;
      int64_t best_steal = -1;
      for (int64_t j = 0; j < m - 1; ++j) {
        const uint32_t freq = cdf_out[j + 1] - cdf_out[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best_steal = j;
        }
      }
      if (best_steal == -1) return -1;

      if (best_steal < i) {
        for (int64_t j = best_steal + 1; j <= i; ++j) cdf_out[j]--;
      } else {
        for (int64_t j = i + 1; j <= best_steal; ++j) cdf_out[j]++;
      }
    }
  }

  if (cdf_out[0] != 0 || cdf_out[m - 1] != (1u << precision)) return -1;
  for (int64_t i = 0; i < m - 1; ++i) {
    if (cdf_out[i + 1] <= cdf_out[i]) return -1;
  }
  return 0;
}

// Batched variant: `rows` PMFs with per-row lengths, writing into a
// [rows, max_len + 2] int32 CDF table (unused tail zeroed by caller).
// pmf is [rows, pmf_stride] row-major; pmf_lengths[i] probabilities are used
// per row, with tail_mass[i] appended as a final symbol.
int32_t stf_pmf_to_quantized_cdf_rows(const float *pmf, int64_t pmf_stride,
                                      const float *tail_mass,
                                      const int32_t *pmf_lengths, int64_t rows,
                                      int32_t precision, int32_t *cdf_out,
                                      int64_t cdf_stride) {
  std::vector<float> row_buf;
  std::vector<uint32_t> cdf_buf;
  for (int64_t r = 0; r < rows; ++r) {
    const int64_t len = pmf_lengths[r];
    row_buf.assign(pmf + r * pmf_stride, pmf + r * pmf_stride + len);
    row_buf.push_back(tail_mass[r]);
    cdf_buf.assign(row_buf.size() + 1, 0);
    const int32_t rc = stf_pmf_to_quantized_cdf(
        row_buf.data(), static_cast<int64_t>(row_buf.size()), precision,
        cdf_buf.data());
    if (rc != 0) return rc;
    int32_t *dst = cdf_out + r * cdf_stride;
    for (size_t i = 0; i < cdf_buf.size(); ++i) {
      dst[i] = static_cast<int32_t>(cdf_buf[i]);
    }
  }
  return 0;
}

}  // extern "C"
