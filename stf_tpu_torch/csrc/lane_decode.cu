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
//      CDF row; rows are strictly increasing and end at 2^16)
//   3. freq = min(cdf[j+1], 2^16) - cdf[j]
//   4. state = freq * (state >> 16) + slot - cdf[j]
//   5. lanes whose state fell below 2^16 take one u16 word each, in lane
//      order, at the group's word cursor
//   6. escapes (j == len-2) take one int32 each, in lane order, from the
//      group's side bank; other lanes emit j + offset.
//
// What bounds it on an H100: the serial chain. Every row depends on the
// previous row's states and cursors, so a segment costs tg = ceil(n/1024)
// dependent steps on 8 SMs whatever the card's bandwidth; the bytes it
// moves (indexes in, symbols out, the compressed stream) take a few
// microseconds at 3.35 TB/s.
//
// What the design does about it: keep each step short. The CDF table
// (64 x 127 int32 on the main path) sits in shared memory, so the search is
// 7 shared loads; the in-row ranks that the TPU kernel computed with
// triangular matmuls are one __ballot_sync + __popc per warp plus a 4-warp
// prefix through shared memory (double-buffered, so one __syncthreads per
// row); each thread keeps its own copy of the two cursors, so no cursor
// lives in shared memory. No atomics: the decode is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr uint32_t kRansL = 1u << 16;

__global__ void __launch_bounds__(kLanes)
lane_decode_kernel(const int32_t* __restrict__ idx, int64_t n, int64_t tg,
                   const int32_t* __restrict__ words, int64_t wcap,
                   const int32_t* __restrict__ side, int64_t scap,
                   const uint32_t* __restrict__ states,
                   const int32_t* __restrict__ cdf, int rows, int width,
                   const int32_t* __restrict__ lengths,
                   const int32_t* __restrict__ offsets,
                   int32_t* __restrict__ out) {
  extern __shared__ int32_t table[];  // cdf rows*width | lengths | offsets
  __shared__ int counts[2][2][kWarps];
  int32_t* lens = table + rows * width;
  int32_t* offs = lens + rows;
  const int g = blockIdx.x;
  const int k = threadIdx.x;
  const int warp = k >> 5;
  const unsigned lower = (1u << (k & 31)) - 1u;

  for (int e = k; e < rows * width; e += kLanes) table[e] = cdf[e];
  for (int e = k; e < rows; e += kLanes) {
    lens[e] = lengths[e];
    offs[e] = offsets[e];
  }
  uint32_t state = states[g * kLanes + k];
  const int32_t* wbank = words + g * wcap;
  const int32_t* sbank = side + g * scap;
  int64_t wpos = 0;  // u16 words consumed by this group
  int64_t spos = 0;  // side values consumed by this group
  __syncthreads();

  for (int64_t t = 0; t < tg; ++t) {
    const int64_t pos = (g * tg + t) * kLanes + k;
    int r = pos < n ? idx[pos] : 0;
    r = min(max(r, 0), rows - 1);  // memory safety for a corrupt index
    const int32_t* row = table + r * width;
    const int len = lens[r];
    const uint32_t slot = state & 0xFFFFu;
    int lo = 0, hi = len - 1;  // invariant: cdf[lo] <= slot < cdf[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if ((uint32_t)row[mid] <= slot) lo = mid; else hi = mid;
    }
    const uint32_t cum = (uint32_t)row[lo];
    const uint32_t nxt = min((uint32_t)row[lo + 1], kRansL);
    state = (nxt - cum) * (state >> 16) + slot - cum;

    const bool renorm = state < kRansL;
    const bool esc = lo == len - 2;
    const unsigned bw = __ballot_sync(0xffffffffu, renorm);
    const unsigned be = __ballot_sync(0xffffffffu, esc);
    const int buf = (int)(t & 1);
    if ((k & 31) == 0) {
      counts[buf][0][warp] = __popc(bw);
      counts[buf][1][warp] = __popc(be);
    }
    __syncthreads();
    int wrank = __popc(bw & lower), srank = __popc(be & lower);
    int wtotal = 0, stotal = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cw = counts[buf][0][w], cs = counts[buf][1][w];
      if (w < warp) {
        wrank += cw;
        srank += cs;
      }
      wtotal += cw;
      stotal += cs;
    }
    if (renorm) {
      const int64_t p = wpos + wrank;
      uint32_t word = 0;
      if (p < 2 * wcap) {
        const uint32_t pair = (uint32_t)wbank[p >> 1];
        word = (p & 1) ? (pair >> 16) : (pair & 0xFFFFu);
      }
      state = (state << 16) | word;
    }
    int32_t val = lo + offs[r];
    if (esc) {
      const int64_t p = spos + srank;
      val = p < scap ? sbank[p] : 0;
    }
    wpos += wtotal;
    spos += stotal;
    if (pos < n) out[pos] = val;
  }
}

}  // namespace

extern "C" {

// Decode n symbols. idx: (n,) int32 row indexes; words: (groups, wcap)
// int32, two little-endian u16 words each; side: (groups, scap) int32;
// states: (groups, 128) u32; cdf: (rows, width) int32 padded past each row's
// length; out: (n,) int32. Launches on `stream`, returns cudaGetLastError().
int stf_lane_decode(const void* idx, int64_t n, int64_t tg, int32_t groups,
                    const void* words, int64_t wcap, const void* side,
                    int64_t scap, const void* states, const void* cdf,
                    int32_t rows, int32_t width, const void* lengths,
                    const void* offsets, void* out, void* stream) {
  const size_t smem = sizeof(int32_t) * ((size_t)rows * width + 2 * rows);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lane_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lane_decode_kernel<<<groups, kLanes, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n, tg, (const int32_t*)words, wcap,
      (const int32_t*)side, scap, (const uint32_t*)states,
      (const int32_t*)cdf, rows, width, (const int32_t*)lengths,
      (const int32_t*)offsets, (int32_t*)out);
  return (int)cudaGetLastError();
}

const char* stf_lane_decode_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
