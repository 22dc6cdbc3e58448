// Kernel B3: interleaved lane-rANS encode of one segment on the GPU.
//
// Replaces the Pallas TPU kernel `_encode_kernel` in
// stf_tpu/ans/lane_coder.py (called through `lane_encode_device`). Same
// stream format as kernel B2 decodes: G = 8 independent row groups x
// K = 128 lanes of rANS32 with 16-bit renormalisation; group g owns
// symbols [g*tg*K, (g+1)*tg*K) of the padded sequence (symbol pad_sym,
// index 0 past n), lane k codes column k of each row. One block per
// group, one thread per lane; two passes:
//   A. forward over rows: a symbol s (relative to its row's offset) with
//      s < 0 or s >= len-2 escapes; its raw value goes to the group's side
//      bank at an ascending cursor, lane-ascending within the row. A row
//      writes while its start cursor is at most (scap_rows-2)*K, so every
//      write stays inside the bank; past that the group's overflow flag
//      is set and the caller re-encodes the segment on the host.
//   B. backward over rows: cum = cdf[r][s], freq = cdf[r][s+1] - cum (s
//      is len-2 for an escape; a direct index, no search); lanes with
//      state >= freq << 16 emit state & 0xFFFF at cursor - n_emit + rank
//      and shift state >>= 16; then state = (state / freq << 16) +
//      state % freq + cum in native u32 arithmetic (the TPU kernel's f32
//      quotient and its fix-up are gone).
// Outputs: words (G, wcap_rows, K) int32, one u16 per cell, each group's
// stream back-filled to end at cell tg*K; side (G, scap_rows, K) int32;
// states (G, K) u32 decoder init states; counts (G, 128) int32 with
// [word count, side count, overflow] in columns 0..2. Every cell no pass
// writes is set to 0. Escapes of 2^24 or more are stored as they are: the
// TPU kernel flagged them only because it scattered through f32.
//
// What bounds it on an H100: the serial chain, as with B2. Each row of a
// group depends on the previous row's cursors (pass A) and lane states
// (pass B), so a segment costs 2*tg dependent row steps on 8 SMs. The
// bytes are ~8 B/symbol in (symbols and indexes, read once per pass) plus
// the stream out: a few microseconds at 3.35 TB/s.
//
// What the design does about it: keep each step short. The CDF table
// (64 x 127 int32 on the main path), lengths and offsets sit in shared
// memory, so a symbol's (cum, freq) is two shared loads; in-row ranks are
// one __ballot_sync + __popc per warp plus a 4-warp prefix through shared
// memory (double-buffered, so one __syncthreads per row); each thread
// keeps its own copy of the group's cursors. No atomics: the output is
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr uint32_t kRansL = 1u << 16;

// The lane's exclusive rank among the row's flagged lanes, and the row's
// total, from one ballot per warp and a 4-warp prefix in `tally[buf]`.
__device__ __forceinline__ void row_rank(bool flag, int buf,
                                         int tally[2][kWarps], int* rank,
                                         int* total) {
  const int k = threadIdx.x, warp = k >> 5;
  const unsigned bits = __ballot_sync(0xffffffffu, flag);
  if ((k & 31) == 0) tally[buf][warp] = __popc(bits);
  __syncthreads();
  int r = __popc(bits & ((1u << (k & 31)) - 1u)), t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = tally[buf][w];
    if (w < warp) r += c;
    t += c;
  }
  *rank = r;
  *total = t;
}

__global__ void __launch_bounds__(kLanes)
lane_encode_kernel(const int32_t* __restrict__ sym,
                   const int32_t* __restrict__ idx, int64_t n, int64_t tg,
                   int32_t pad_sym, const int32_t* __restrict__ cdf,
                   int rows, int width, const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ offsets,
                   int32_t* __restrict__ words, int64_t wcap_rows,
                   int32_t* __restrict__ side, int64_t scap_rows,
                   uint32_t* __restrict__ states,
                   int32_t* __restrict__ counts) {
  extern __shared__ int32_t table[];  // cdf rows*width | lengths | offsets
  __shared__ int tally[2][kWarps];
  int32_t* lens = table + rows * width;
  int32_t* offs = lens + rows;
  const int g = blockIdx.x;
  const int k = threadIdx.x;

  for (int e = k; e < rows * width; e += kLanes) table[e] = cdf[e];
  for (int e = k; e < rows; e += kLanes) {
    lens[e] = lengths[e];
    offs[e] = offsets[e];
  }
  int32_t* wbank = words + g * wcap_rows * kLanes;
  int32_t* sbank = side + g * scap_rows * kLanes;
  const int64_t gbase = g * tg * kLanes;
  const int64_t limit = (scap_rows - 2) * kLanes;
  __syncthreads();

  // pass A: escapes to the side bank, forward
  int64_t scur = 0;     // escapes so far in this group
  int64_t swrote = 0;   // end of the side cells written
  int overflow = 0;
  for (int64_t t = 0; t < tg; ++t) {
    const int64_t pos = gbase + t * kLanes + k;
    const int32_t v = pos < n ? sym[pos] : pad_sym;
    int r = pos < n ? idx[pos] : 0;
    r = min(max(r, 0), rows - 1);  // memory safety for a corrupt index
    const int32_t s = v - offs[r];
    const bool esc = s < 0 || s >= lens[r] - 2;
    wbank[t * kLanes + k] = 0;  // pass B back-fills the stream's cells
    int rank, total;
    row_rank(esc, (int)(t & 1), tally, &rank, &total);
    if (scur <= limit) {
      if (esc) sbank[scur + rank] = v;
      swrote = scur + total;
    }
    if (scur + total > limit) overflow = 1;
    scur += total;
  }
  wbank[tg * kLanes + k] = 0;  // the pad row
  for (int64_t p = swrote + k; p < scap_rows * kLanes; p += kLanes) sbank[p] = 0;
  __syncthreads();  // the zeroed word cells before pass B's writes

  // pass B: reverse interleaved rANS, words back-filled
  uint32_t state = kRansL;
  int64_t wcur = tg * kLanes;
  for (int64_t t = tg - 1; t >= 0; --t) {
    const int64_t pos = gbase + t * kLanes + k;
    const int32_t v = pos < n ? sym[pos] : pad_sym;
    int r = pos < n ? idx[pos] : 0;
    r = min(max(r, 0), rows - 1);
    const int len = lens[r];
    int s = v - offs[r];
    if (s < 0 || s >= len - 2) s = len - 2;
    const int32_t* row = table + r * width;
    const uint32_t cum = (uint32_t)row[s];
    const uint32_t freq = (uint32_t)row[s + 1] - cum;
    const bool emit = (uint64_t)state >= ((uint64_t)freq << 16);
    int rank, total;
    row_rank(emit, (int)((tg - 1 - t) & 1), tally, &rank, &total);
    if (emit) {
      wbank[wcur - total + rank] = (int32_t)(state & 0xFFFFu);
      state >>= 16;
    }
    state = ((state / freq) << 16) + state % freq + cum;
    wcur -= total;
  }
  states[g * kLanes + k] = state;
  const int64_t c = k == 0 ? tg * kLanes - wcur
                  : k == 1 ? scur
                  : k == 2 ? overflow : 0;
  counts[g * 128 + k] = (int32_t)c;
}

}  // namespace

extern "C" {

// Encode n symbols. sym, idx: (n,) int32; cdf: (rows, width) int32 padded
// past each row's length; words: (groups, wcap_rows, 128) int32; side:
// (groups, scap_rows, 128) int32; states: (groups, 128) u32; counts:
// (groups, 128) int32. Launches on `stream`, returns cudaGetLastError().
int stf_lane_encode_device(const void* sym, const void* idx, int64_t n,
                           int64_t tg, int32_t groups, int32_t pad_sym,
                           const void* cdf, int32_t rows, int32_t width,
                           const void* lengths, const void* offsets,
                           void* words, int64_t wcap_rows, void* side,
                           int64_t scap_rows, void* states, void* counts,
                           void* stream) {
  const size_t smem = sizeof(int32_t) * ((size_t)rows * width + 2 * rows);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lane_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lane_encode_kernel<<<groups, kLanes, smem, (cudaStream_t)stream>>>(
      (const int32_t*)sym, (const int32_t*)idx, n, tg, pad_sym,
      (const int32_t*)cdf, rows, width, (const int32_t*)lengths,
      (const int32_t*)offsets, (int32_t*)words, wcap_rows, (int32_t*)side,
      scap_rows, (uint32_t*)states, (int32_t*)counts);
  return (int)cudaGetLastError();
}

const char* stf_lane_encode_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
