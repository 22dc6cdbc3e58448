// Kernel B2: interleaved lane-rANS decode of one segment on the GPU.
//
// Replaces the Pallas TPU kernel `_decode_kernel` in
// stf_tpu/ans/lane_coder.py (called through `lane_decode_device`). Same
// stream format: G = 8 independent row groups x K = 128 lanes of rANS32
// with 16-bit renormalisation; group g owns symbols [g*tg*K, (g+1)*tg*K) of
// the zero-padded index sequence, row t of the group is symbols
// [t*K, (t+1)*K) of it, lane k decodes column k. Per row and lane:
//   1. slot = state & 0xFFFF
//   2. j = largest index with cdf[j] <= slot (binary search of the lane's
//      CDF row; rows are strictly increasing to 2^16, then SENTINEL pads)
//   3. freq = min(cdf[j+1], 2^16) - cdf[j]
//   4. state = freq * (state >> 16) + slot - cdf[j]
//   5. lanes whose state fell below 2^16 take one u16 word each, in lane
//      order, at the group's word cursor
//   6. escapes (j == len-2) take one int32 each, in lane order, from the
//      group's side bank; other lanes emit j + offset.
// Reads past a bank's end give 0.
//
// What bounds it on an H100: the serial chain. Row t + 1 of a group needs
// row t's lane states and word cursor, so a segment costs tg =
// ceil(n/1024) dependent steps on 8 SMs whatever the card's bandwidth
// (its bytes take well under a microsecond at 3.35 TB/s). A step's least
// latency is its dependent shared loads (5 halvings of the search, the
// CDF pair, the word) and ~33 dependent integer operations: ~350 SM
// cycles, 0.017 ms for the main path's 96 rows at 1980 MHz. One warp
// runs the whole step, ~300 instructions for 128 lanes at most one a
// cycle, on top of that latency; splitting the lanes over two warps costs
// more in the per-row exchange of their counts than it saves.
//
// What the design does about it: nothing but registers and shared memory
// on the chain, and no block barrier per row.
//   * One warp (the chain warp) decodes all 128 lanes of its group, four
//     per thread (lane j*32 + thread); the in-row ranks come from four
//     ballots, so a row needs no shared counts and no barrier. The four
//     searches of a thread are independent, so their loads overlap, and
//     the row loop is unrolled LANE_DECODE_UNROLL times so the scheduler
//     can fill one row's waits with the next row's reads.
//   * The CDF table, lengths and offsets sit in shared memory, each row
//     padded with SENTINEL to a power-of-two width (a template parameter),
//     so the search is a fixed run of halvings whose column offsets are
//     immediates of the loads, plus one SENTINEL column: the odd row stride
//     puts the same column of different rows in different banks (with a
//     power-of-two stride the 32 lanes' top-level reads are a 32-way bank
//     conflict). A row's table row, length and offset, and the top
//     LANE_DECODE_PRE levels of its search tree, are read one row ahead,
//     off the chain.
//   * Three staging warps keep the chain fed in chunks of
//     LANE_DECODE_CHUNK rows: with cp.async they copy the next chunk's
//     indexes into one of two buffers and the words the next chunk may
//     take into a ring (a chunk of C rows takes at most C*128 words, so
//     the ring holds the 2*C*128 words from the cursor at the chunk's
//     start on, zero past the bank's end). They also finish the chunk
//     before: the chain warp writes an escape's side position in place of
//     its value, the stagers copy the side value over it (cp.async, zero
//     past the bank) and store the chunk to device memory, coalesced. The
//     block meets once per chunk (__syncthreads), never per row.
//   * Cursors and positions are 32-bit on the chain.
// No atomics: the decode is deterministic. tools/compare_lane_decode.py
// times builds with other values of the three LANE_DECODE_* settings.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef LANE_DECODE_CHUNK
#define LANE_DECODE_CHUNK 16  // rows a chunk; a power of two
#endif
#ifndef LANE_DECODE_PRE
#define LANE_DECODE_PRE 2  // search-tree levels read a row ahead
#endif
#ifndef LANE_DECODE_UNROLL
#define LANE_DECODE_UNROLL 4  // rows a turn of the chain's loop
#endif

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 128;  // warp 0 decodes, warps 1-3 stage
constexpr int kStagers = kThreads - 32;
constexpr int kChunk = LANE_DECODE_CHUNK;
constexpr int kChunkCells = kChunk * kLanes;
constexpr int kRingPairs = 2 * kChunkCells;  // u32 word pairs
constexpr int kPre = LANE_DECODE_PRE;
constexpr int kUnroll = LANE_DECODE_UNROLL;
constexpr uint32_t kRansL = 1u << 16;
constexpr int32_t kSentinel = 1 << 20;
static_assert((kChunk & (kChunk - 1)) == 0, "chunk must be a power of two");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4-byte async copy of src[i] to shared dst, or of nothing (dst becomes
// 0) where i >= limit.
template <typename T>
__device__ __forceinline__ void copy4(void* dst, const T* src, int64_t i,
                                      int64_t limit) {
  const bool ok = i < limit;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src + (ok ? i : 0)), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ld.shared.b32 at a shared address plus a constant byte offset
template <int kOff>
__device__ __forceinline__ int lds(uint32_t addr) {
  int v;
  asm("ld.shared.b32 %0, [%1+%2];\n" : "=r"(v) : "r"(addr), "n"(kOff));
  return v;
}

// The search tree of a row padded to 2^S columns: the halving at depth d
// compares cdf[lo + 2^(S-1-d)]. Node i (heap order: its children are
// 2i+1, taken when that cdf > slot, and 2i+2) sits at depth d with path q
// (its bits the right turns, the first the highest) and compares column
// q * 2^(S-d) + 2^(S-1-d).
__host__ __device__ constexpr int node_col(int i, int s) {
  int d = 0;
  while ((2 << d) - 1 <= i) ++d;
  return ((i + 1 - (1 << d)) << (s - d)) + ((1 << s) >> (d + 1));
}

template <int S>
struct Tree {
  static constexpr int top = (1 << S) >> 1;
  static constexpr int pre = S < kPre ? S : kPre;  // levels read ahead
  static constexpr int nodes = (1 << pre) - 1;
};

// What the chain warp reads of a row before the row's states are known:
// per lane of the thread, the shared address of its CDF row, its length,
// its symbol offset and the values of the top levels of its search tree.
template <int S>
struct RowAhead {
  uint32_t row[4];
  int len[4], off[4];
  int node[4][Tree<S>::nodes > 0 ? Tree<S>::nodes : 1];
};

template <int S>
__device__ __forceinline__ void read_ahead(RowAhead<S>& a, const int32_t* ib,
                                           const int32_t* tbl,
                                           const int32_t* lens,
                                           const int32_t* offs, int rows) {
  constexpr int stride = (1 << S) + 1;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int r = ib[j * 32 + tid];
    r = min(max(r, 0), rows - 1);  // memory safety for a corrupt index
    const int32_t* row = tbl + r * stride;
    a.row[j] = smem_addr(row);
    a.len[j] = lens[r];
    a.off[j] = offs[r];
#pragma unroll
    for (int i = 0; i < Tree<S>::nodes; ++i)
      a.node[j][i] = row[node_col(i, S)];
  }
}

// The halvings from kStep columns down: a[j] is the shared address of
// cdf[lo], and becomes that of the largest cdf <= slot.
template <int kStep>
__device__ __forceinline__ void halve(uint32_t (&a)[4],
                                      const uint32_t (&slot)[4]) {
  if constexpr (kStep > 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = lds<4 * kStep>(a[j]);
      a[j] = v <= (int)slot[j] ? a[j] + 4 * kStep : a[j];
    }
    halve<kStep / 2>(a, slot);
  }
}

template <int S>  // log2 of the padded table width
__global__ void __launch_bounds__(kThreads)
lane_decode_kernel(const int32_t* __restrict__ idx, int64_t n, int tg,
                   const uint32_t* __restrict__ words, int wcap,
                   const int32_t* __restrict__ side, int scap,
                   const uint32_t* __restrict__ states,
                   const int32_t* __restrict__ cdf, int rows, int width,
                   const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ offsets,
                   int32_t* __restrict__ out) {
  // ring | idx x2 | out x2 | escape masks x2 | table | lengths | offsets
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int wstart[2];  // word cursor at a chunk's start, by parity
  uint32_t* ring = smem;
  int32_t* idx_s = (int32_t*)(ring + kRingPairs);
  int32_t* out_s = idx_s + 2 * kChunkCells;
  uint32_t* escm = (uint32_t*)(out_s + 2 * kChunkCells);
  int32_t* tbl = (int32_t*)(escm + 2 * kChunk * 4);
  constexpr int stride = (1 << S) + 1;  // odd: a column's rows fall in all banks
  int32_t* lens = tbl + rows * stride;
  int32_t* offs = lens + rows;

  const int g = blockIdx.x;
  const int k = threadIdx.x;
  const int64_t gbase = (int64_t)g * tg * kLanes;
  const int nrem = (int)max(min(n - gbase, (int64_t)tg * kLanes), (int64_t)0);
  const int32_t* gidx = idx + gbase;
  const uint32_t* wbank = words + (int64_t)g * wcap;
  const int32_t* sbank = side + (int64_t)g * scap;
  int32_t* gout = out + gbase;
  const int nch = (tg + kChunk - 1) / kChunk;

  // prologue, all threads: the table with 16-byte loads where aligned,
  // chunk 0's indexes and the first 2*C*128 words by cp.async
  const int cells = rows * width;
  int e0 = 0;
  if ((((uintptr_t)cdf) & 15) == 0) {
    const int4* c4 = (const int4*)cdf;
    for (int q = k; q < cells / 4; q += kThreads) {
      const int4 v = __ldg(c4 + q);
      const int vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * q + i, r = e / width;
        tbl[r * stride + e - r * width] = vals[i];
      }
    }
    e0 = cells & ~3;
  }
  for (int e = e0 + k; e < cells; e += kThreads) {
    const int r = e / width;
    tbl[r * stride + e - r * width] = __ldg(cdf + e);
  }
  const int pad = stride - width;  // cdf[j+1] reads up to column 2^S
  for (int e = k; e < rows * pad; e += kThreads) {
    const int r = e / pad;
    tbl[r * stride + width + e - r * pad] = kSentinel;
  }
  if (k == 0) wstart[0] = 0;
  for (int e = k; e < rows; e += kThreads) {
    lens[e] = __ldg(lengths + e);
    offs[e] = __ldg(offsets + e);
  }
  for (int e = k; e < min(kChunkCells, tg * kLanes); e += kThreads)
    copy4(idx_s + e, gidx, e, nrem);
  for (int q = k; q < kChunkCells; q += kThreads)
    copy4(ring + q, wbank, q, wcap);
  int wload = kChunkCells;  // stagers: pairs [0, wload) are in the ring

  uint32_t st[4];
  if (k < 32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) st[j] = states[g * kLanes + j * 32 + k];
  }
  copy_wait();
  __syncthreads();

  const uint16_t* ring16 = (const uint16_t*)ring;
  int wpos = 0, spos = 0;  // chain warp: words / side values consumed
  for (int c = 0; c <= nch; ++c) {
    const int buf = c & 1;
    if (k < 32) {
      if (c < nch) {
        // -- the chain: rows [c*C, c*C + nrows) of the group --
        const int nrows = min(kChunk, tg - c * kChunk);
        const int32_t* ib = idx_s + buf * kChunkCells;
        int32_t* ob = out_s + buf * kChunkCells;
        const unsigned lower = (1u << k) - 1u;
        RowAhead<S> next;
        read_ahead(next, ib, tbl, lens, offs, rows);
#pragma unroll (kUnroll)
        for (int t = 0; t < nrows; ++t) {
          const RowAhead<S> cur = next;
          // no branch, so the reads can fill the search's waits; past the
          // chunk's last row they read the next buffer, clamped and unused
          read_ahead(next, ib + (t + 1) * kLanes, tbl, lens, offs, rows);
          uint32_t slot[4], at[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            slot[j] = st[j] & 0xFFFFu;
            int node = 0, lo = 0;
#pragma unroll
            for (int l = 0; l < Tree<S>::pre; ++l) {
              // the node's value by selects (a register array indexed at
              // run time would go to local memory)
              int v = cur.node[j][(1 << l) - 1];
#pragma unroll
              for (int i = 1 << l; i < (2 << l) - 1; ++i)
                v = node == i ? cur.node[j][i] : v;
              const bool go = v <= (int)slot[j];
              lo += go ? Tree<S>::top >> l : 0;
              node = 2 * node + 1 + go;
            }
            at[j] = cur.row[j] + 4 * lo;
          }
          halve<(Tree<S>::top >> Tree<S>::pre)>(at, slot);
          unsigned bw[4], be[4];
          int lo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t cum = (uint32_t)lds<0>(at[j]);
            const uint32_t nxt = min((uint32_t)lds<4>(at[j]), kRansL);
            lo[j] = (int)(at[j] - cur.row[j]) >> 2;
            st[j] = (nxt - cum) * (st[j] >> 16) + slot[j] - cum;
            bw[j] = __ballot_sync(0xffffffffu, st[j] < kRansL);
            be[j] = __ballot_sync(0xffffffffu, lo[j] == cur.len[j] - 2);
          }
          int wb = wpos, sb = spos;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // every lane reads a word (the ring has no holes); the
            // renormalising ones take it, without a branch
            const uint32_t p = (uint32_t)(wb + __popc(bw[j] & lower));
            const uint32_t word = ring16[p & (2 * kRingPairs - 1)];
            st[j] = st[j] < kRansL ? (st[j] << 16) | word : st[j];
            // an escape's cell holds its side position until the stagers
            // copy the value over it
            const bool esc = (be[j] >> k) & 1u;
            ob[t * kLanes + j * 32 + k] =
                esc ? sb + __popc(be[j] & lower) : lo[j] + cur.off[j];
            wb += __popc(bw[j]);
            sb += __popc(be[j]);
          }
          wpos = wb;
          spos = sb;
          if (k == 0)
            *(uint4*)(escm + (buf * kChunk + t) * 4) =
                make_uint4(be[0], be[1], be[2], be[3]);
        }
        if (k == 0) wstart[buf ^ 1] = wpos;
      }
    } else {
      // -- the stagers: feed chunk c + 1, finish chunk c - 1 --
      const int s = k - 32;
      if (c + 1 < nch) {
        const int first = (c + 1) * kChunkCells;
        const int cnt = min(kChunkCells, tg * kLanes - first);
        int32_t* dst = idx_s + (buf ^ 1) * kChunkCells;
        for (int e = s; e < cnt; e += kStagers)
          copy4(dst + e, gidx, first + e, nrem);
      }
      if (c < nch) {
        // chunk c + 1 reads words below wstart(c) + 2*C*128
        const int wend = (wstart[buf] + 2 * kChunkCells + 1) >> 1;
        for (int q = wload + s; q < wend; q += kStagers)
          copy4(ring + (q & (kRingPairs - 1)), wbank, q, wcap);
        wload = max(wload, wend);
      }
      const int prev = c - 1;
      const int cnt =
          prev >= 0 ? min(kChunkCells, tg * kLanes - prev * kChunkCells) : 0;
      int32_t* ob = out_s + (buf ^ 1) * kChunkCells;
      const uint32_t* em = escm + (buf ^ 1) * kChunk * 4;
      for (int e = s; e < cnt; e += kStagers) {
        if ((em[e >> 5] >> (e & 31)) & 1u) {
          copy4(ob + e, sbank, ob[e], scap);
        }
      }
      copy_wait();
      const int first = prev * kChunkCells;
      for (int e = s; e < cnt; e += kStagers)
        if (first + e < nrem) gout[first + e] = ob[e];
    }
    __syncthreads();
  }
}

template <int S>
int launch(const void* idx, int64_t n, int64_t tg, int32_t groups,
           const void* words, int64_t wcap, const void* side, int64_t scap,
           const void* states, const void* cdf, int32_t rows, int32_t width,
           const void* lengths, const void* offsets, void* out, size_t smem,
           void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lane_decode_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lane_decode_kernel<S><<<groups, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n, (int)tg, (const uint32_t*)words, (int)wcap,
      (const int32_t*)side, (int)scap, (const uint32_t*)states,
      (const int32_t*)cdf, rows, width, (const int32_t*)lengths,
      (const int32_t*)offsets, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Decode n symbols. idx: (n,) int32 row indexes; words: (groups, wcap)
// int32, two little-endian u16 words each; side: (groups, scap) int32;
// states: (groups, 128) u32; cdf: (rows, width) int32 padded past each row's
// length; out: (n,) int32. Launches on `stream`, returns cudaGetLastError()
// (or cudaErrorInvalidValue for sizes past the kernel's 32-bit positions or
// a table too wide for shared memory).
int stf_lane_decode(const void* idx, int64_t n, int64_t tg, int32_t groups,
                    const void* words, int64_t wcap, const void* side,
                    int64_t scap, const void* states, const void* cdf,
                    int32_t rows, int32_t width, const void* lengths,
                    const void* offsets, void* out, void* stream) {
  int shift = 0;
  while ((1 << shift) < width) ++shift;
  const int64_t lim = (int64_t)1 << 30;
  const size_t smem =
      sizeof(int32_t) * ((size_t)kRingPairs + 4 * (size_t)kChunkCells +
                         8 * (size_t)kChunk +
                         (size_t)rows * ((1 << shift) + 3));
  if (tg * kLanes >= lim || wcap >= lim || scap >= lim || n < 0 ||
      rows < 1 || width < 1 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  switch (shift) {
#define LANE_DECODE_WIDTH(S)                                              \
  case S:                                                                 \
    return launch<S>(idx, n, tg, groups, words, wcap, side, scap, states, \
                     cdf, rows, width, lengths, offsets, out, smem, stream);
    LANE_DECODE_WIDTH(0) LANE_DECODE_WIDTH(1) LANE_DECODE_WIDTH(2)
    LANE_DECODE_WIDTH(3) LANE_DECODE_WIDTH(4) LANE_DECODE_WIDTH(5)
    LANE_DECODE_WIDTH(6) LANE_DECODE_WIDTH(7) LANE_DECODE_WIDTH(8)
    LANE_DECODE_WIDTH(9)
#undef LANE_DECODE_WIDTH
  }
  return (int)cudaErrorInvalidValue;
}

const char* stf_lane_decode_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
