// Dependent-latency probe for a chain floor: one thread times a chain of
// shared loads (each address the value of the load before) and a chain of
// integer multiply-adds (each operand the result before) with clock64().
// Built and run by tools/compare_lane_decode.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 1024;

__global__ void latency_probe_kernel(long long* out, int iters, int a, int b) {
  __shared__ int next[kSlots];
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x)
    next[i] = (i + 33) % kSlots;  // a cycle through every slot
  __syncthreads();
  if (threadIdx.x != 0) return;
  int p = 0;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < iters; ++i) p = next[p];
  const long long t1 = clock64();
  int x = p;
#pragma unroll 16
  for (int i = 0; i < iters; ++i) x = x * a + b;
  const long long t2 = clock64();
  out[0] = t1 - t0;
  out[1] = t2 - t1;
  out[2] = x;  // keeps both chains live
}

}  // namespace

extern "C" {

// out: 3 int64 on the device: cycles of `iters` dependent shared loads,
// cycles of `iters` dependent multiply-adds, and the chains' result.
int stf_latency_probe(void* out, int iters, int a, int b, void* stream) {
  latency_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (long long*)out, iters, a, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
