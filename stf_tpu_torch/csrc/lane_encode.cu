// Kernel B3: interleaved lane-rANS encode of one segment on the GPU.
//
// Replaces the Pallas TPU kernel `_encode_kernel` in
// stf_tpu/ans/lane_coder.py (called through `lane_encode_device`). Same
// stream format as kernel B2 decodes: G = 8 independent row groups x
// K = 128 lanes of rANS32 with 16-bit renormalisation; group g owns
// symbols [g*tg*K, (g+1)*tg*K) of the padded sequence (symbol pad_sym,
// index 0 past n), lane k codes column k of each row. One block per
// group; two passes:
//   A. escapes, forward: a symbol s (relative to its row's offset) with
//      s < 0 or s >= len-2 escapes; its raw value goes to the group's side
//      bank at an ascending cursor, lane-ascending within the row. A row
//      writes while its start cursor is at most (scap_rows-2)*K, so every
//      write stays inside the bank; past that the group's overflow flag
//      is set and the caller re-encodes the segment on the host.
//   B. rANS, backward over rows: cum = cdf[r][s], freq = cdf[r][s+1] - cum
//      (s is len-2 for an escape); lanes with state >= freq << 16 emit
//      state & 0xFFFF at cursor - n_emit + rank and shift state >>= 16;
//      then state = (state / freq << 16) + state % freq + cum in u32.
// Outputs: words (G, wcap_rows, K) int32, one u16 per cell, each group's
// stream back-filled to end at cell tg*K; side (G, scap_rows, K) int32;
// states (G, K) u32 decoder init states; counts (G, 128) int32 with
// [word count, side count, overflow] in columns 0..2. Every cell no pass
// writes is set to 0. Escapes of 2^24 or more are stored as they are: the
// TPU kernel flagged them only because it scattered through f32.
//
// What bounds it on an H100: pass B's serial chain. Row t - 1 of a group
// needs row t's lane states and word cursor, so a segment costs tg =
// ceil(n/1024) dependent steps on 8 SMs whatever the card's bandwidth
// (~8 bytes a symbol in and the stream out take a few microseconds at
// 3.35 TB/s). Nothing in a step needs the table: (cum, freq) depend on the
// symbol and index, never on the state. So a step is one warp's ~100
// instructions for 128 lanes, with a least latency of one lane's state
// update: ~8 dependent integer operations once the division is a multiply
// by a reciprocal set out ahead (nvcc's u32 division is ~20 instructions,
// three of them in the quarter-rate conversion and reciprocal units).
//
// What the design does about it (the shape of kernel B2, mirrored), with
// twelve warps; warp w runs on scheduler w % 4, and a warp alone on its
// scheduler waits out its own latencies, so the parallel work gets
// several warps on each:
//   * Pass A carries only the side cursor, a prefix sum of per-row escape
//     counts, so it has no row loop that carries a cursor: chunks of 32
//     rows arrive by cp.async three deep; each warp counts the escapes of
//     its rows (warp, warp + 12, warp + 24) with four ballots a row (a
//     thread takes four neighbouring lanes, one 16-byte load); every warp
//     scans the chunk's 32 counts with shuffles and writes its rows'
//     escapes at start + rank. Two block barriers a chunk; only the
//     chunk's total is carried.
//   * Pass B runs on one warp (the chain warp, warp 0), four lanes a
//     thread (lane j*32 + thread); in-row ranks and the row's word count
//     come from four ballots, so a row needs no shared counts and no
//     barrier. Emitting lanes store their words straight to device memory
//     (stores do not wait). x / freq is umulhi(x, floor((2^32-1)/freq))
//     and one correction: for x < 2^32 the estimate is the quotient or one
//     less. The row loop is unrolled LANE_ENCODE_UNROLL times.
//   * The nine warps on schedulers 1-3 feed the chain in chunks of
//     LANE_ENCODE_CHUNK rows, the top (partial) chunk first: with cp.async
//     they copy a chunk's symbols and indexes two chunks ahead, and turn
//     the chunk after the chain's current one into coding cells in shared
//     memory, {(freq << 16) - 1, the reciprocal, freq, cum}, so the chain
//     makes one 16-byte shared load a lane a row and no lookup. Warps 4
//     and 8 only wait in pass B, so the chain has its scheduler to itself.
//     The block meets once a chunk (__syncthreads), never a row.
//   * The words bank is zeroed before pass A; the chain's stores come
//     after a barrier, so none is overwritten.
//   * Cursors and positions are 32-bit. No atomics: the output is
//     deterministic. tools/compare_lane_encode.py times this build against
//     an earlier one and builds with other LANE_ENCODE_* settings.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LANE_ENCODE_CHUNK
#define LANE_ENCODE_CHUNK 16  // pass B rows a chunk
#endif
#ifndef LANE_ENCODE_UNROLL
#define LANE_ENCODE_UNROLL 8  // rows a turn of the chain's loop
#endif
#ifndef LANE_ENCODE_STAMPS  // 1: counts columns 3-5 take the SM cycles of
#define LANE_ENCODE_STAMPS 0  // the prologue, pass A and pass B (warp 0's)
#endif

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 384;  // pass A: all; pass B: warp 0 encodes, 9 stage
constexpr int kWarps = kThreads / 32;
constexpr int kStagers = kThreads * 3 / 4;
constexpr int kChunk = LANE_ENCODE_CHUNK;
constexpr int kChunkCells = kChunk * kLanes;
constexpr int kUnroll = LANE_ENCODE_UNROLL;
constexpr int kScanRows = 32;  // pass A rows a chunk: one warp's scan
constexpr int kScanCells = kScanRows * kLanes;
constexpr int kRowsPerWarp = (kScanRows + kWarps - 1) / kWarps;
constexpr int kScanBufs = 3;  // pass A chunks in shared memory at once
constexpr int kStagerQuads = (kChunkCells / 4 + kStagers - 1) / kStagers;
constexpr uint32_t kRansL = 1u << 16;
static_assert(2 * kChunkCells * 4 <= kScanBufs * 2 * kScanCells,
              "pass B's cells must fit in pass A's buffers");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Async copy of cells [i, i + 4) of src to shared dst, the cells at or
// past `limit` zero: one 16-byte copy where src is 16-byte aligned, else
// four 4-byte copies.
__device__ __forceinline__ void copy_quad(int32_t* dst, const int32_t* src,
                                          int i, int limit, bool aligned) {
  if (aligned) {
    const int valid = max(0, min(4, limit - i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src + (valid ? i : 0)), "r"(4 * valid)
                 : "memory");
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = i + q < limit;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(dst + q)),
                   "l"(src + (ok ? i + q : 0)), "r"(ok ? 4 : 0)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0 or 1) of this thread's copy groups are
// in flight
__device__ __forceinline__ void copy_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// s < 0 or s >= len - 2, in one unsigned compare
__device__ __forceinline__ bool escapes(int s, int len) {
  return (unsigned)s >= (unsigned)(len - 2);
}

// A cell's symbol and clamped table row: (pad_sym, 0) at or past the
// group's `nrem` cells.
struct Cell {
  int32_t v;
  int r;
};

__device__ __forceinline__ Cell cell(int32_t v, int r, bool valid,
                                     int32_t pad_sym, int rows) {
  Cell c;
  c.v = valid ? v : pad_sym;
  c.r = min(max(valid ? r : 0, 0), rows - 1);  // memory safety for a corrupt index
  return c;
}

__global__ void __launch_bounds__(kThreads)
lane_encode_kernel(const int32_t* __restrict__ sym,
                   const int32_t* __restrict__ idx, int64_t n, int tg,
                   int32_t pad_sym, const int32_t* __restrict__ cdf,
                   int rows, int width, const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ offsets,
                   int32_t* __restrict__ words, int wcap,
                   int32_t* __restrict__ side, int scap,
                   uint32_t* __restrict__ states,
                   int32_t* __restrict__ counts) {
  // pass A chunks x3 (pass B's coding cells x2 after it) | pass B raw x2 |
  // table | (offset, length) a table row
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ int row_escapes[kScanRows];
  int32_t* abuf = smem;
  uint4* coding = (uint4*)smem;
  int32_t* braw = abuf + kScanBufs * 2 * kScanCells;
  int32_t* tbl = braw + 2 * 2 * kChunkCells;
  int2* offlen = (int2*)(tbl + ((rows * width + 1) & ~1));

  long long stamps[4] = {};  // LANE_ENCODE_STAMPS: the phases' start cycles
  if (LANE_ENCODE_STAMPS) stamps[0] = clock64();
  const int g = blockIdx.x;
  const int k = threadIdx.x;
  const int warp = k >> 5, lane = k & 31;
  const bool stager = (warp & 3) != 0;
  const int sid = (warp - 1 - (warp >> 2)) * 32 + lane;  // stagers: 0..287
  const unsigned lower = (1u << lane) - 1u;
  const int64_t gbase = (int64_t)g * tg * kLanes;
  const int nrem = (int)max(min(n - gbase, (int64_t)tg * kLanes), (int64_t)0);
  const int32_t* gsym = sym + gbase;
  const int32_t* gidx = idx + gbase;
  const bool aligned =
      ((((uintptr_t)gsym) | ((uintptr_t)gidx)) & 15) == 0;
  int32_t* wbank = words + (int64_t)g * wcap;
  int32_t* sbank = side + (int64_t)g * scap;
  const int limit = scap - 2 * kLanes;
  const int nch = (tg + kChunk - 1) / kChunk;  // pass B chunks
  const int nscan = (tg + kScanRows - 1) / kScanRows;  // pass A chunks

  // pass B chunk c holds rows [q*C, q*C + nrows), q = nch - 1 - c: the
  // stagers copy its symbols and indexes into raw buffer c & 1
  auto stage_copy = [&](int c) {
    const int q = nch - 1 - c;
    const int first = q * kChunkCells;
    const int quads = min(kChunk, tg - q * kChunk) * (kLanes / 4);
    int32_t* dst = braw + (c & 1) * 2 * kChunkCells;
    for (int e = sid; e < quads; e += kStagers) {
      copy_quad(dst + 4 * e, gsym, first + 4 * e, nrem, aligned);
      copy_quad(dst + kChunkCells + 4 * e, gidx, first + 4 * e, nrem, aligned);
    }
    copy_commit();
  };
  // ... and turn the same cells (each stager the cells it copied) into
  // coding cells in buffer c & 1: what the chain needs of (cum, freq),
  // {(freq << 16) - 1 (emit above it), floor((2^32 - 1) / freq), freq,
  // cum}. All of a stager's cells are read before any is written, so
  // their lookups and divisions overlap.
  auto stage_coding = [&](int c) {
    const int q = nch - 1 - c;
    const int first = q * kChunkCells;
    const int quads = min(kChunk, tg - q * kChunk) * (kLanes / 4);
    const int32_t* src = braw + (c & 1) * 2 * kChunkCells;
    uint4* dst = coding + (c & 1) * kChunkCells;
    int4 sv[kStagerQuads], iv[kStagerQuads];
#pragma unroll
    for (int u = 0; u < kStagerQuads; ++u) {
      const int e = min(sid + u * kStagers, kChunkCells / 4 - 1);
      sv[u] = *(const int4*)(src + 4 * e);
      iv[u] = *(const int4*)(src + kChunkCells + 4 * e);
    }
#pragma unroll
    for (int u = 0; u < kStagerQuads; ++u) {
      const int e = sid + u * kStagers;
      const int32_t vs[4] = {sv[u].x, sv[u].y, sv[u].z, sv[u].w};
      const int is[4] = {iv[u].x, iv[u].y, iv[u].z, iv[u].w};
      uint4 out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Cell x = cell(vs[i], is[i], first + 4 * e + i < nrem, pad_sym, rows);
        const int2 ol = offlen[x.r];
        int s = x.v - ol.x;
        s = escapes(s, ol.y) ? ol.y - 2 : s;
        const int32_t* row = tbl + x.r * width;
        const uint32_t cum = (uint32_t)row[s];
        const uint32_t freq = (uint32_t)row[s + 1] - cum;
        out[i] = make_uint4((freq << 16) - 1u, 0xFFFFFFFFu / max(freq, 1u),
                            freq, cum);
      }
      if (e < quads) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[4 * e + i] = out[i];
      }
    }
  };
  // pass A chunk i holds rows [i*32, i*32 + 32): all threads copy it into
  // buffer i % 3
  auto scan_copy = [&](int i) {
    const int first = i * kScanCells;
    const int quads = min(kScanRows, tg - i * kScanRows) * (kLanes / 4);
    int32_t* dst = abuf + (i % kScanBufs) * 2 * kScanCells;
    for (int e = k; e < quads; e += kThreads) {
      copy_quad(dst + 4 * e, gsym, first + 4 * e, nrem, aligned);
      copy_quad(dst + kScanCells + 4 * e, gidx, first + 4 * e, nrem, aligned);
    }
    copy_commit();
  };

  // prologue: pass B's first two chunks and pass A's first two in flight,
  // then the table, and the words bank zeroed (pass B back-fills it)
  if (stager) {
    stage_copy(0);
    if (nch > 1) stage_copy(1);
  }
  scan_copy(0);
  if (nscan > 1) scan_copy(1);
  const int cells = rows * width;
  int e0 = 0;
  if ((((uintptr_t)cdf) & 15) == 0) {
    const int4* c4 = (const int4*)cdf;
#pragma unroll 4
    for (int q = k; q < cells / 4; q += kThreads)
      *(int4*)(tbl + 4 * q) = __ldg(c4 + q);
    e0 = cells & ~3;
  }
  for (int e = e0 + k; e < cells; e += kThreads) tbl[e] = __ldg(cdf + e);
  for (int e = k; e < rows; e += kThreads)
    offlen[e] = make_int2(__ldg(offsets + e), __ldg(lengths + e));
  for (int e = k; e < wcap / 4; e += kThreads)
    ((int4*)wbank)[e] = make_int4(0, 0, 0, 0);

  // -- pass A: the side bank --
  if (LANE_ENCODE_STAMPS) stamps[1] = clock64();
  int carry = 0;   // escapes in the chunks before
  int swrote = 0;  // end of the side cells written
  for (int i = 0; i < nscan; ++i) {
    copy_wait(i + 1 < nscan);
    __syncthreads();  // chunk i (and the table) in, chunk i - 1 done
    if (i + 2 < nscan) scan_copy(i + 2);
    const int nrows = min(kScanRows, tg - i * kScanRows);
    const int32_t* as = abuf + (i % kScanBufs) * 2 * kScanCells;
    // A warp's rows warp + 12m at once (no branch around a ballot, so
    // their loads overlap): per row, the thread's escaping lanes (4 bits)
    // and the row's escapes in lanes before its own
    int4 sv[kRowsPerWarp];
    int info[kRowsPerWarp];
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int rr = min(warp + kWarps * m, kScanRows - 1);
      sv[m] = *(const int4*)(as + rr * kLanes + 4 * lane);
    }
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int rr = warp + kWarps * m;
      const int4 iv = *(const int4*)(as + kScanCells +
                                     min(rr, kScanRows - 1) * kLanes + 4 * lane);
      const int32_t vs[4] = {sv[m].x, sv[m].y, sv[m].z, sv[m].w};
      const int is[4] = {iv.x, iv.y, iv.z, iv.w};
      const int pos = (i * kScanRows + rr) * kLanes + 4 * lane;
      int flags = 0, before = 0, total = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const Cell x = cell(vs[q], is[q], pos + q < nrem, pad_sym, rows);
        const int2 ol = offlen[x.r];
        const bool esc = (rr < nrows) & escapes(x.v - ol.x, ol.y);
        const unsigned b = __ballot_sync(0xffffffffu, esc);
        flags |= esc << q;
        before += __popc(b & lower);
        total += __popc(b);
      }
      info[m] = flags | (before << 4);
      if (lane == 0 && rr < nrows) row_escapes[rr] = total;
    }
    __syncthreads();  // the chunk's counts
    // every warp scans the 32 counts: lane l holds row l's start cursor
    const int c = lane < nrows ? row_escapes[lane] : 0;
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    const int start = carry + incl - c;
    const bool writes = lane < nrows && start <= limit;
    swrote = max(swrote, (int)__reduce_max_sync(
                             0xffffffffu, writes ? (unsigned)(carry + incl) : 0u));
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int rr = warp + kWarps * m;
      const int at = __shfl_sync(0xffffffffu, start, rr & 31);
      const int flags = info[m] & 15;
      if (flags && at <= limit) {  // flags: rr < nrows
        const int32_t vs[4] = {sv[m].x, sv[m].y, sv[m].z, sv[m].w};
        const int pos = (i * kScanRows + rr) * kLanes + 4 * lane;
        int p = at + (info[m] >> 4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if ((flags >> q) & 1) {
            sbank[p] = pos + q < nrem ? vs[q] : pad_sym;
            ++p;
          }
        }
      }
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  for (int p = swrote + k; p < scap; p += kThreads) sbank[p] = 0;
  __syncthreads();  // pass A's buffers free for pass B's coding cells
  if (LANE_ENCODE_STAMPS) stamps[2] = clock64();

  // -- pass B: reverse interleaved rANS, words back-filled --
  if (stager) {
    copy_wait(0);
    stage_coding(0);
    if (nch > 2) stage_copy(2);
  }
  __syncthreads();
  uint32_t st[4] = {kRansL, kRansL, kRansL, kRansL};
  int wcur = tg * kLanes;
  for (int c = 0; c < nch; ++c) {
    if (warp == 0) {
      // -- the chain: chunk c's rows, last first --
      const int nrows = min(kChunk, tg - (nch - 1 - c) * kChunk);
      const uint4* cb = coding + (c & 1) * kChunkCells;
#pragma unroll (kUnroll)
      for (int i = 0; i < nrows; ++i) {
        const uint4* row = cb + (nrows - 1 - i) * kLanes + lane;
        uint4 cc[4];
        bool emit[4];
        unsigned b[4];
        int total = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cc[j] = row[j * 32];
          emit[j] = st[j] > cc[j].x;  // state >= freq << 16
          b[j] = __ballot_sync(0xffffffffu, emit[j]);
          total += __popc(b[j]);
        }
        wcur -= total;
        int at = wcur;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (emit[j]) wbank[at + __popc(b[j] & lower)] = (int32_t)(st[j] & 0xFFFFu);
          at += __popc(b[j]);
          // x / freq by the reciprocal: x < freq << 16 <= 2^32, so the
          // estimate is the quotient or one less
          const uint32_t x = emit[j] ? st[j] >> 16 : st[j];
          uint32_t quo = __umulhi(x, cc[j].y);
          uint32_t rem = x - quo * cc[j].z;
          if (rem >= cc[j].z) {
            ++quo;
            rem -= cc[j].z;
          }
          st[j] = (quo << 16) + rem + cc[j].w;
        }
      }
    } else if (stager && c + 1 < nch) {
      // -- the stagers: coding cells for chunk c + 1, symbols for c + 3 --
      copy_wait(c + 2 < nch);
      stage_coding(c + 1);
      if (c + 3 < nch) stage_copy(c + 3);
    }
    __syncthreads();
  }
  if (LANE_ENCODE_STAMPS) stamps[3] = clock64();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = j * 32 + lane;
      const int phase = min(max(col - 3, 0), 2);
      states[g * kLanes + col] = st[j];
      counts[g * 128 + col] =
          col == 0   ? tg * kLanes - wcur
          : col == 1 ? carry
          : col == 2 ? (int)(carry > limit)
          : LANE_ENCODE_STAMPS && col < 6
              ? (int)(stamps[phase + 1] - stamps[phase])
              : 0;
    }
  }
}

}  // namespace

extern "C" {

// Encode n symbols. sym, idx: (n,) int32; cdf: (rows, width) int32 padded
// past each row's length; words: (groups, wcap_rows, 128) int32, 16-byte
// aligned; side: (groups, scap_rows, 128) int32; states: (groups, 128) u32;
// counts: (groups, 128) int32. Launches on `stream`, returns
// cudaGetLastError() (or cudaErrorInvalidValue for sizes past the kernel's
// 32-bit positions, a misaligned words bank or a table too wide for
// shared memory).
int stf_lane_encode_device(const void* sym, const void* idx, int64_t n,
                           int64_t tg, int32_t groups, int32_t pad_sym,
                           const void* cdf, int32_t rows, int32_t width,
                           const void* lengths, const void* offsets,
                           void* words, int64_t wcap_rows, void* side,
                           int64_t scap_rows, void* states, void* counts,
                           void* stream) {
  const int64_t lim = (int64_t)1 << 30;
  const size_t smem =
      sizeof(int32_t) * ((size_t)kScanBufs * 2 * kScanCells +
                         4 * (size_t)kChunkCells +
                         (((size_t)rows * width + 1) & ~(size_t)1) +
                         2 * (size_t)rows);
  if (tg < 1 || tg * kLanes >= lim || wcap_rows * kLanes >= lim ||
      scap_rows * kLanes >= lim || scap_rows < 2 || n < 0 || rows < 1 ||
      width < 2 || smem > 227 * 1024 || (((uintptr_t)words) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      lane_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  lane_encode_kernel<<<groups, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sym, (const int32_t*)idx, n, (int)tg, pad_sym,
      (const int32_t*)cdf, rows, width, (const int32_t*)lengths,
      (const int32_t*)offsets, (int32_t*)words, (int)(wcap_rows * kLanes),
      (int32_t*)side, (int)(scap_rows * kLanes), (uint32_t*)states,
      (int32_t*)counts);
  return (int)cudaGetLastError();
}

const char* stf_lane_encode_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
