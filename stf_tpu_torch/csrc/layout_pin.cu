// Kernel B4: layout pin, a bit-exact copy of a strided tensor into a fresh
// densely packed row-major tensor.
//
// Replaces the Pallas TPU kernel `_pin_kernel` in
// stf_tpu/ans/lane_coder.py (called through `layout_pin`). On the TPU the
// pin was an opaque custom call whose output layout XLA could not choose,
// so every operand of the fused decode walk had the same buffer layout as
// in the per-slice programs, and the bf16 matmuls consuming it summed in
// the same order. It is not a no-op on this card either:
//   * the decoder's symbols arrive as NHWC tensors viewed as NCHW, and
//     `hyper_synthesize` returns views ([:, :, :h, :w], models/base.py);
//     the memory format of a convolution's operand decides cuDNN's
//     algorithm and so its summation order;
//   * the fused decompress captures its walk into one CUDA graph, and the
//     pin gives every operand of that walk the same canonical layout in
//     the graph as in the eager per-slice walk, which is what it did for
//     XLA on the TPU.
// Of the 32 pins per fused decompress (WACNN, 10 slices), 11 change
// strides: z_hat (an NHWC view of the uploaded buffer) and the 10 rv (NHWC
// symbols viewed as NCHW; the pin is their only copy). The other 21 copy
// packed tensors: lm and ls, whose crop keeps every element because the
// decoder's y_shape is the hyper output's 4 x z (so the [:h, :w] view has
// packed strides at every image size), the first mu, and each slice's mu
// and y_prev, which convolutions wrote packed; those pins only keep JAX's
// positions. `chip_smoke.py` phase 7 counts the 32 by path (21 packed,
// 11 transpose per replay, measured on an H100).
//
// What bounds it on an H100: bytes (each element read once, written once)
// and, below about 1 MB, the launch itself. The host-side planner
// (`pin_plan`, ans/lane_coder.py) drops size-1 dims, merges dims whose
// strides chain, and picks one of three paths from the merged geometry:
//   * packed (one dim, stride 1; 21 of the 32 pins): a flat copy in the
//     widest word (up to 16 B) that the source pointer allows, then a
//     byte tail;
//   * transpose (inner stride != 1, the next dim stride 1: an NHWC tensor
//     viewed as NCHW; the other 11): 32 x 32 tiles through shared memory
//     with a padding column against bank conflicts, reads coalesced along
//     the source's unit-stride dim and writes along the output's, outer
//     dims in blockIdx.z;
//   * general (anything else: a crop, an expanded stride-0 or a doubly
//     permuted view; no pin of the fused decompress): one thread per
//     output element, the source offset from its 4-d coordinates, in
//     32-bit arithmetic when the tensor allows it.
// Each of the two fast paths beats the general path on every main-path
// operand that takes it, in device time on an H100, and stays within
// 1.25x of PyTorch's copy of the same operand (tools/compare_layout_pin.py,
// PERF.md section 6); no crop reaches the kernel on the main path, so
// crops take the general path.
// Elements move as unsigned words of their width or wider, so NaN payloads
// and -0.0 keep their bits. No atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum Kind { kPacked = 0, kTranspose = 1, kGeneral = 2 };

// -- packed ----------------------------------------------------------------

template <typename W>
__global__ void __launch_bounds__(kThreads)
pin_packed(const W* __restrict__ src, W* __restrict__ dst, int64_t nw,
           const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail,
           int tail_bytes) {
  const int64_t first = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = first; i < nw; i += step) dst[i] = src[i];
  if (first < tail_bytes) dst_tail[first] = src_tail[first];
}

template <typename W>
int launch_packed(const void* src, void* dst, int64_t nbytes,
                  cudaStream_t stream) {
  const int64_t nw = nbytes / (int64_t)sizeof(W);
  const int tail = (int)(nbytes - nw * (int64_t)sizeof(W));
  int64_t blocks = (nw + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  pin_packed<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const W*)src, (W*)dst, nw, (const uint8_t*)src + nw * sizeof(W),
      (uint8_t*)dst + nw * sizeof(W), tail);
  return (int)cudaGetLastError();
}

// -- transpose -------------------------------------------------------------

struct TransGeo {
  int64_t s0, s1, sk;  // outer strides and the inner dim's, in elements
  int o1;              // outer size below the first
  int m, k;            // the unit-stride dim and the inner dim
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
pin_transpose(const T* __restrict__ src, T* __restrict__ dst, TransGeo g) {
  __shared__ T tile[32][33];
  const int z = blockIdx.z;
  const int i0 = z / g.o1, i1 = z - i0 * g.o1;
  const T* s = src + i0 * g.s0 + i1 * g.s1;
  T* d = dst + (int64_t)z * g.m * g.k;
  const int m0 = blockIdx.y * 32, k0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int k = k0 + ty + j, m = m0 + tx;
    if (k < g.k && m < g.m) tile[ty + j][tx] = s[m + k * g.sk];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int m = m0 + ty + j, k = k0 + tx;
    if (m < g.m && k < g.k) d[(int64_t)m * g.k + k] = tile[tx][ty + j];
  }
}

template <typename T>
int launch_transpose(const void* src, void* dst, const int64_t* sizes,
                     const int64_t* strides, cudaStream_t stream) {
  TransGeo g;
  g.s0 = strides[0];
  g.s1 = strides[1];
  g.sk = strides[3];
  g.o1 = (int)sizes[1];
  g.m = (int)sizes[2];
  g.k = (int)sizes[3];
  dim3 grid((unsigned)((g.k + 31) / 32), (unsigned)((g.m + 31) / 32),
            (unsigned)(sizes[0] * sizes[1]));
  pin_transpose<T><<<grid, dim3(32, 8), 0, stream>>>((const T*)src, (T*)dst,
                                                     g);
  return (int)cudaGetLastError();
}

// -- general ---------------------------------------------------------------

template <typename I>
struct Geometry {
  I size[4];
  I stride[4];  // in elements
};

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
pin_general(const T* __restrict__ src, T* __restrict__ dst, I n,
            Geometry<I> geo) {
  for (I i = blockIdx.x * (I)kThreads + threadIdx.x; i < n;
       i += (I)gridDim.x * kThreads) {
    I rem = i, off = 0;
#pragma unroll
    for (int d = 3; d >= 0; --d) {
      const I q = rem / geo.size[d];
      off += (rem - q * geo.size[d]) * geo.stride[d];
      rem = q;
    }
    dst[i] = src[off];
  }
}

template <typename T, typename I>
int launch_general_as(const void* src, void* dst, int64_t n,
                      const int64_t* sizes, const int64_t* strides,
                      cudaStream_t stream) {
  Geometry<I> geo;
  for (int d = 0; d < 4; ++d) {
    geo.size[d] = (I)sizes[d];
    geo.stride[d] = (I)strides[d];
  }
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  pin_general<T, I><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)src, (T*)dst, (I)n, geo);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_general(const void* src, void* dst, const int64_t* sizes,
                   const int64_t* strides, cudaStream_t stream) {
  int64_t n = 1, reach = 0;
  for (int d = 0; d < 4; ++d) {
    n *= sizes[d];
    reach += (sizes[d] - 1) * strides[d];
  }
  // 32-bit indices when i + blockDim * gridDim and every offset fit
  if (n + (int64_t)kThreads * kMaxBlocks < INT32_MAX && reach < INT32_MAX)
    return launch_general_as<T, int32_t>(src, dst, n, sizes, strides, stream);
  return launch_general_as<T, int64_t>(src, dst, n, sizes, strides, stream);
}

template <typename T>
int launch_elementwise(int kind, const void* src, void* dst,
                       const int64_t* sizes, const int64_t* strides,
                       cudaStream_t stream) {
  if (kind == kTranspose)
    return launch_transpose<T>(src, dst, sizes, strides, stream);
  return launch_general<T>(src, dst, sizes, strides, stream);
}

}  // namespace

extern "C" {

// Copy a strided tensor from `src` into the packed row-major `dst` along
// the path `kind` chosen by `pin_plan` (0 packed, 1 transpose, 2 general).
// sizes[0..3] and strides[0..3] (in elements) are the plan's merged
// geometry with leading dims of size 1: packed holds the element count in
// sizes[3]; transpose is (outer x2, the unit-stride dim, the inner dim).
// elem_size is 1, 2 or 4 bytes; `word` (packed only) the bytes each
// thread moves at once, a power of two from elem_size to 16 that divides
// the source pointer. `dst` is 16-byte aligned. Launches on `stream`,
// returns cudaGetLastError() (cudaErrorInvalidValue for a geometry that
// breaks these rules).
int stf_layout_pin(const void* src, void* dst, int kind, int elem_size,
                   int word, const int64_t* sizes, const int64_t* strides,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!(elem_size == 1 || elem_size == 2 || elem_size == 4))
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case kPacked: {
      const bool word_ok = word >= elem_size && word <= 16
                           && !(word & (word - 1))
                           && (uintptr_t)src % word == 0
                           && (uintptr_t)dst % 16 == 0;
      if (!word_ok) return (int)cudaErrorInvalidValue;
      const int64_t nbytes = sizes[3] * elem_size;
      switch (word) {
        case 1: return launch_packed<uint8_t>(src, dst, nbytes, st);
        case 2: return launch_packed<uint16_t>(src, dst, nbytes, st);
        case 4: return launch_packed<uint32_t>(src, dst, nbytes, st);
        case 8: return launch_packed<uint2>(src, dst, nbytes, st);
        default: return launch_packed<uint4>(src, dst, nbytes, st);
      }
    }
    case kTranspose:
      if (strides[2] != 1 || (sizes[2] + 31) / 32 > 65535
          || sizes[0] * sizes[1] > 65535)
        return (int)cudaErrorInvalidValue;
      break;
    case kGeneral:
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  switch (elem_size) {
    case 1:
      return launch_elementwise<uint8_t>(kind, src, dst, sizes, strides, st);
    case 2:
      return launch_elementwise<uint16_t>(kind, src, dst, sizes, strides, st);
    default:
      return launch_elementwise<uint32_t>(kind, src, dst, sizes, strides, st);
  }
}

const char* stf_layout_pin_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
