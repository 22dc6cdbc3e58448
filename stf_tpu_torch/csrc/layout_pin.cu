// Kernel B4: layout pin, a bit-exact copy of a strided tensor into a fresh
// densely packed row-major tensor.
//
// Replaces the Pallas TPU kernel `_pin_kernel` in
// stf_tpu/ans/lane_coder.py (called through `layout_pin`). On the TPU the
// pin was an opaque custom call whose output layout XLA could not choose,
// so every operand of the fused decode walk had the same buffer layout as
// in the per-slice programs, and the bf16 matmuls consuming it summed in
// the same order. It is not a no-op on this card either:
//   * the port's `hyper_synthesize` returns cropped views
//     ([:, :, :h, :w], models/base.py) and the decoder's symbols arrive as
//     NHWC tensors viewed as NCHW; the memory format of a convolution's
//     operand decides cuDNN's algorithm and so its summation order;
//   * the fused decompress captures its walk into one CUDA graph, and the
//     pin gives every operand of that walk the same canonical layout in
//     the graph as in the eager per-slice walk, which is what it did for
//     XLA on the TPU.
// Of the 32 pins per fused decompress (WACNN, 10 slices), 13 change
// strides on this card: z_hat (an NHWC view of the uploaded buffer), lm
// and ls (cropped views) and the 10 rv (NHWC symbols viewed as NCHW; the
// pin is their only copy). The other 19, the first mu and each slice's
// mu and y_prev, copy tensors that convolutions already wrote packed;
// they are kept only to pin where the JAX walk pins.
// Elements of 1, 2 or 4 bytes move as unsigned integers of that width, so
// NaN payloads and -0.0 keep their bits. Up to 4 dims (leading dims padded
// with size 1).
//
// What bounds it on an H100: bytes (each element read once, written once)
// and, at the fused decode's sizes (at most 3.9 MB), the launch itself.
// The design: one thread per output element in a grid-stride loop, so the
// writes are coalesced; the source offset comes from the element's 4-d
// coordinates and the given strides. No shared memory, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geometry {
  int64_t size[4];
  int64_t stride[4];  // in elements
};

template <typename T>
__global__ void layout_pin_kernel(const T* __restrict__ src,
                                  T* __restrict__ dst, int64_t n,
                                  Geometry geo) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t rem = i, off = 0;
#pragma unroll
    for (int d = 3; d >= 0; --d) {
      const int64_t c = rem % geo.size[d];
      rem /= geo.size[d];
      off += c * geo.stride[d];
    }
    dst[i] = src[off];
  }
}

template <typename T>
int launch(const void* src, void* dst, int64_t n, const Geometry& geo,
           cudaStream_t stream) {
  constexpr int kThreads = 256;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  layout_pin_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)src, (T*)dst, n, geo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Copy the n elements of a (sizes[0..3]) tensor with element strides
// strides[0..3] from `src` into the packed row-major `dst`. elem_size is
// 1, 2 or 4. Launches on `stream`, returns cudaGetLastError().
int stf_layout_pin(const void* src, void* dst, int64_t n, int elem_size,
                   const int64_t* sizes, const int64_t* strides,
                   void* stream) {
  Geometry geo;
  for (int d = 0; d < 4; ++d) {
    geo.size[d] = sizes[d];
    geo.stride[d] = strides[d];
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (elem_size) {
    case 1: return launch<uint8_t>(src, dst, n, geo, st);
    case 2: return launch<uint16_t>(src, dst, n, geo, st);
    case 4: return launch<uint32_t>(src, dst, n, geo, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* stf_layout_pin_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
