// Kernel B1: the (shifted-)window attention core, read straight from the
// qkv projection and written straight back at the window's pixels.
//
// Replaces the Pallas TPU kernel `_attn_kernel` in
// stf_tpu/layers/pallas_attention.py (wrapper `pallas_window_attention`,
// used by `WindowAttention._pallas_core` in stf_tpu/layers/win_attention.py).
// For every window w and head h:
//   out = softmax(q*scale . k^T + bias[h] + shift_penalty[w]) . v
// with f32 accumulation; shift_penalty is -100 where the two tokens carry
// different shift-region labels (the reference's SW-MSA mask value) and 0
// otherwise.
//
// Layout. qkv is the (B, H, W, 3C) output of the qkv nn.Linear on the
// (already rolled) NHWC map. Token n of window (p, q) sits at pixel
// (p*ws + n/ws, q*ws + n%ws); head h's channels are [h*hd, (h+1)*hd) plus
// 0, C or 2C for q, k, v. The output (B, H, W, C) is head-concatenated at
// the same pixels, so no partition/un-partition copies exist. The labels
// are the (nW, N) int32 per-token region ids; no (N, N) mask tensor exists.
//
// What bounds it on an H100: bytes, narrowly. Per (window, head) it does
// 4*N*N*hd flops while moving 16*N*hd bytes (q, k, v in, out back), N/4
// flops per byte: 16 at N = 64 and 4 at N = 16, against the 20 flops per
// byte at which the card's f32 rate (67 TFLOP/s, no tensor cores) meets
// its 3.35 TB/s. So the bound is (qkv read + output written) / 3.35 TB/s,
// with the f32 flop time close behind at N = 64.
//
// What the design does about it: read each qkv element once. One block
// serves one window and HB heads (HB*N = 128 threads, one query row per
// thread); K and V of those heads are staged in shared memory, the query
// row and the N scores live in registers (N and hd are template
// parameters), and the softmax and P.V run in registers with no
// intermediate in device memory. This first version does not use tensor
// cores; hd = 24 / 40 are not wgmma-friendly widths, and it is memory bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <int N, int HD>
__global__ void __launch_bounds__(128)
window_attention_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const int32_t* __restrict__ labels,
                        float* __restrict__ out, int H, int W, int ws, int C,
                        float scale) {
  extern __shared__ float smem[];
  const int HB = blockDim.y;
  const int i = threadIdx.x;   // query token within the window
  const int hl = threadIdx.y;  // head within this block
  const int h = blockIdx.y * HB + hl;
  const int Q = W / ws;
  const int nW = (H / ws) * Q;
  const int win = blockIdx.x % nW;
  const int b = blockIdx.x / nW;
  const int p = win / Q, q = win % Q;
  const int64_t C3 = 3 * (int64_t)C;

  float* ks = smem + hl * 2 * N * HD;
  float* vs = ks + N * HD;
  int32_t* labs = (int32_t*)(smem + HB * 2 * N * HD);

  for (int e = i; e < N * HD; e += N) {
    const int n = e / HD, d = e % HD;
    const int64_t pix =
        ((int64_t)b * H + p * ws + n / ws) * W + q * ws + n % ws;
    ks[e] = qkv[pix * C3 + C + h * HD + d];
    vs[e] = qkv[pix * C3 + 2 * C + h * HD + d];
  }
  if (labels != nullptr && hl == 0) labs[i] = labels[win * N + i];
  __syncthreads();

  const int64_t pix = ((int64_t)b * H + p * ws + i / ws) * W + q * ws + i % ws;
  float qr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) qr[d] = qkv[pix * C3 + h * HD + d] * scale;

  const float* brow = bias + ((int64_t)h * N + i) * N;
  const int li = labels != nullptr ? labs[i] : 0;
  float s[N];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc += qr[d] * ks[j * HD + d];
    acc += brow[j];
    if (labels != nullptr && labs[j] != li) acc += -100.f;
    s[j] = acc;
    mx = fmaxf(mx, acc);
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j] = expf(s[j] - mx);
    sum += s[j];
  }
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float pj = s[j] / sum;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] += pj * vs[j * HD + d];
  }
  float* orow = out + pix * C + h * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) orow[d] = o[d];
}

template <int N, int HD>
int launch(const float* qkv, const float* bias, const int32_t* labels,
           float* out, int B, int H, int W, int ws, int C, int nh,
           float scale, cudaStream_t stream) {
  int hb = 128 / N;
  if (hb > nh) hb = nh;
  while (nh % hb) --hb;
  const size_t smem = sizeof(float) * (size_t)hb * 2 * N * HD
                      + sizeof(int32_t) * N;
  auto kernel = window_attention_kernel<N, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nW = (H / ws) * (W / ws);
  dim3 grid(B * nW, nh / hb);
  dim3 block(N, hb);
  kernel<<<grid, block, smem, stream>>>(qkv, bias, labels, out, H, W, ws, C,
                                        scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when (N, hd) has a compiled instance, else 0: WACNN's two geometries,
// 8x8 windows at head width 24 and 4x4 windows at head width 40. Each
// instance unrolls N x hd fully and costs build time, so only shapes a
// ported model runs are compiled.
int stf_window_attention_supported(int32_t n, int32_t hd) {
  return (n == 64 && hd == 24) || (n == 16 && hd == 40);
}

// qkv: (B, H, W, 3C) f32; bias: (nh, N, N) f32; labels: (nW, N) int32 or
// null; out: (B, H, W, C) f32. Launches on `stream`, returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported shape).
int stf_window_attention(const void* qkv, const void* bias,
                         const void* labels, void* out, int32_t B, int32_t H,
                         int32_t W, int32_t ws, int32_t C, int32_t nh,
                         float scale, void* stream) {
  const float* q = (const float*)qkv;
  const float* bs = (const float*)bias;
  const int32_t* lb = (const int32_t*)labels;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = ws * ws, hd = C / nh;
  if (n == 64 && hd == 24)
    return launch<64, 24>(q, bs, lb, o, B, H, W, ws, C, nh, scale, st);
  if (n == 16 && hd == 40)
    return launch<16, 40>(q, bs, lb, o, B, H, W, ws, C, nh, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* stf_window_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
