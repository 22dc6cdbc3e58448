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
// with the f32 FMA time close behind at N = 64 (0.036 against 0.045 ms
// at WACNN's 128x192 map, batch 2). Versions of this kernel on the FMA
// pipes were bound by instruction issue (FMAs, shared loads, index
// arithmetic), not by bytes; this one moves both products to the tensor
// cores, so what is left is the staging latency and the softmax.
//
// Design. One block per (window, head): N / 16 warps (4 at N = 64, 1 at
// N = 16), each owning 16 query rows.
//   * staging: q, k and v of the head are copied into shared memory with
//     16-byte cp.async (a head's hd floats are 16-byte aligned at both
//     widths), q and k as one group and v as a second, so S starts while
//     v is in flight. Rows are padded to hd + 4 floats, so the fragment
//     loads below (8 rows x 4 columns a warp) hit 32 distinct banks;
//   * both products run on the tensor cores, mma.sync m16n8k8 TF32 with
//     f32 accumulation, in 3xTF32: each f32 operand is split into a TF32
//     "big" part and a TF32 remainder, and big*big + big*small +
//     small*big keeps about 21 bits of each product (plain TF32 keeps 10,
//     which would miss the 1e-5 tolerance against the f32 plain version).
//     Measured on an H100 (PERF.md section 6): max error 3.8e-6 at 8x8 and
//     2.0e-6 at 4x4; an f32-FMA version of this kernel was 14-16% slower;
//   * S = q k^T stays in the accumulator registers; the bias (read from
//     global memory as float2: every window reads the same bias, so it
//     stays in L2), the -100 shift penalty from the labels, and the row
//     softmax (max and sum across the 4 lanes of a row with xor shuffles,
//     each lane ending with the same bits; one reciprocal per row) work on
//     them in place;
//   * the softmax needs only logit - rowmax, but the bias and the penalty
//     can take a logit to ~100, where an f32 rounding (ulp 7.6e-6) of the
//     logit itself costs more than the whole tolerance over a full map. So
//     a first pass takes the row max m of the logits as f32 rounds them,
//     and a second rereads bias and labels and forms (hi - m) + (s * scale
//     + lo), hi + lo being bias + penalty exactly (TwoSum): each rounding
//     is then of a number the size of logit - m. With the bias x30 this
//     kernel lands 2.4e-6 from an f64 plain version at 8x8, the f32 plain
//     version 8.8e-6 and a one-pass kernel 9.1e-6; the second pass costs
//     about 16% at 8x8 (PERF.md section 6);
//   * P . v takes P from those registers as its A fragments: inside each
//     8-key tile the key order is permuted (fragment column t <-> key 2t,
//     t + 4 <-> key 2t + 1) and v's rows are read in the same order, so
//     the sum is unchanged and P never touches shared memory;
//   * the output leaves the accumulators as float2 stores, a lane quad
//     writing one whole 32-byte sector of a row.
// No atomics, and every sum runs in a fixed order (mma.sync is
// deterministic), so two launches on the same input give the same bits.
//
// Occupancy, chosen on the card (PERF.md section 6): at N = 64 a block holds
// 21.5 KB of shared memory and __launch_bounds__(128, 6) caps a thread at
// 85 registers (it uses 80), so six blocks (24 warps) fit on an SM; a
// two-buffer persistent block that loads the next window during the
// current one measured 10-40% slower (fewer warps left to hide the
// latencies). At N = 16 a block is one warp: 8.4 KB at hd 40 (WACNN),
// 3.8 KB at hd 16 (STF's every stage). There registers, not shared
// memory, limit the blocks an SM holds (at most 32), and MINB caps them:
// 64 a thread at MINB 32, which ran 1.5% faster than 8, 16 or 24 on the
// card (PERF.md section 6).
// At hd 16 a head's slice of a qkv row is 64 bytes, so it stays 16-byte
// aligned for cp.async; S takes 2 k-tiles and P . v 2 n-tiles; rows of
// hd + 4 = 20 floats keep the fragment loads on 32 distinct banks. Index
// arithmetic is by compile-time constants (N, hd): an earlier version with
// a run-time head-group size spent as many instructions on the staging
// loop's divisions as on S.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// 3xTF32: x = big + small, both TF32 (10-bit mantissas), so that
// big*big' + big*small' + small*big' keeps about 21 bits of each product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// d += a . b on one m16n8k8 TF32 tile, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const float b0, const float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// Shared memory: q, k and v of one (window, head), rows padded to hd + 4
// floats. A warp owns 16 query rows; in the m16n8k8 fragments lane
// (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 and, of each
// 8-column tile of S or the output, columns 2t and 2t + 1.
template <int WS, int HD>
struct Geometry {
  static constexpr int N = WS * WS;
  static constexpr int TEAM = 2 * N;  // N / 16 warps
  static constexpr int QP = HD + 4;
  static constexpr int FLOATS = 3 * N * QP;
  static_assert(N % 16 == 0 && HD % 8 == 0, "m16n8k8 tiles");
};

// One block per (window, head); grid x = window * nh + head.
template <int WS, int HD, int MINB>
__global__ void __launch_bounds__(Geometry<WS, HD>::TEAM, MINB)
window_attention_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const int32_t* __restrict__ labels,
                        float* __restrict__ out, int H, int W, int C, int nh,
                        float scale) {
  using G = Geometry<WS, HD>;
  constexpr int N = G::N, TEAM = G::TEAM, QP = G::QP, C4 = HD / 4;
  constexpr int NT = N / 8, DT = HD / 8;  // 8-wide tiles of keys and of hd
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + N * QP;
  float* vs = ks + N * QP;

  const int h = blockIdx.x % nh;
  const int bw = blockIdx.x / nh;
  const int Q = W / WS;
  const int nW = (H / WS) * Q;
  const int win = bw % nW, b = bw / nW;
  const int wp = win / Q, wq = win - wp * Q;
  const int64_t C3 = 3 * (int64_t)C;
  const int tid = threadIdx.x;
  const float* base = qkv + ((int64_t)b * H + wp * WS) * W * C3
                      + (int64_t)wq * WS * C3 + h * HD;
  auto pixel = [&](int n) { return (int64_t)(n / WS) * W + n % WS; };

  // stage q and k (one cp.async group), then v (a second one): per token
  // hd/4 16-byte chunks each; S waits for the first group only
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    for (int e = tid; e < N * C4; e += TEAM) {
      const int n = e / C4, c = e - n * C4;
      cp_async16(smem + which * N * QP + n * QP + 4 * c,
                 base + pixel(n) * C3 + which * C + 4 * c);
    }
    if (which != 0) asm volatile("cp.async.commit_group;\n" ::);
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16 + g;  // this lane's rows: r0 and r0 + 8

  // S = q k^T for the warp's 16 rows: NT tiles of 16 x 8
  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    uint32_t ab[4], as[4];
    const float* q0 = qs + r0 * QP + 8 * kk + t;
    split_tf32(q0[0], ab[0], as[0]);
    split_tf32(q0[8 * QP], ab[1], as[1]);
    split_tf32(q0[4], ab[2], as[2]);
    split_tf32(q0[8 * QP + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* k0 = ks + (8 * n + g) * QP + 8 * kk + t;
      mma_3xtf32(s[n], ab, as, k0[0], k0[4]);
    }
  }

  // bias, shift penalty, row softmax over the 4 lanes sharing a row;
  // s[n][0..1] are row r0, s[n][2..3] row r0 + 8, columns 8n + 2t + {0, 1}.
  // Pass 1 takes each row's max m of the logits as f32 rounds them; pass 2
  // rereads bias and labels and forms logit - m without rounding the
  // logit itself (see the note at the top)
  const float* brow = bias + ((int64_t)h * N + r0) * N + 2 * t;
  const int32_t* lab = labels != nullptr ? labels + (int64_t)win * N : nullptr;
  const int li0 = lab != nullptr ? __ldg(lab + r0) : 0;
  const int li1 = lab != nullptr ? __ldg(lab + r0 + 8) : 0;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 b0 = __ldg((const float2*)(brow + 8 * n));
    const float2 b1 = __ldg((const float2*)(brow + 8 * N + 8 * n));
    const float bv[4] = {b0.x, b0.y, b1.x, b1.y};
    const int lj0 = lab != nullptr ? __ldg(lab + 8 * n + 2 * t) : 0;
    const int lj1 = lab != nullptr ? __ldg(lab + 8 * n + 2 * t + 1) : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = s[n][i] * scale + bv[i];
      if ((i & 1 ? lj1 : lj0) != (i < 2 ? li0 : li1)) v += -100.f;
      if (i < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 b0 = __ldg((const float2*)(brow + 8 * n));
    const float2 b1 = __ldg((const float2*)(brow + 8 * N + 8 * n));
    const float bv[4] = {b0.x, b0.y, b1.x, b1.y};
    const int lj0 = lab != nullptr ? __ldg(lab + 8 * n + 2 * t) : 0;
    const int lj1 = lab != nullptr ? __ldg(lab + 8 * n + 2 * t + 1) : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bias + penalty as the unevaluated sum hi + lo (TwoSum)
      float hi = bv[i], lo = 0.f;
      if ((i & 1 ? lj1 : lj0) != (i < 2 ? li0 : li1)) {
        hi = bv[i] + -100.f;
        const float bb = hi - bv[i];
        lo = (bv[i] - (hi - bb)) + (-100.f - bb);
      }
      s[n][i] = (hi - (i < 2 ? mx0 : mx1)) + fmaf(s[n][i], scale, lo);
    }
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = expf(s[n][0]);
    s[n][1] = expf(s[n][1]);
    s[n][2] = expf(s[n][2]);
    s[n][3] = expf(s[n][3]);
    sum0 += s[n][0] + s[n][1];
    sum1 += s[n][2] + s[n][3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(kFull, sum0, o);
    sum1 += __shfl_xor_sync(kFull, sum1, o);
  }
  const float rinv0 = 1.f / sum0, rinv1 = 1.f / sum1;

  // out = P v. P stays in registers: the key order inside each 8-key tile
  // is permuted (A-fragment column t <-> key 2t, t + 4 <-> 2t + 1), and v's
  // rows are read in the same order, so S's accumulator tile n is the A
  // fragment of key tile n
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t ab[4], as[4];
    split_tf32(s[n][0] * rinv0, ab[0], as[0]);
    split_tf32(s[n][2] * rinv1, ab[1], as[1]);
    split_tf32(s[n][1] * rinv0, ab[2], as[2]);
    split_tf32(s[n][3] * rinv1, ab[3], as[3]);
    const float* v0 = vs + (8 * n + 2 * t) * QP + g;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      mma_3xtf32(o[d], ab, as, v0[8 * d], v0[QP + 8 * d]);
  }

  // o[d][0..1] are row r0, o[d][2..3] row r0 + 8, channels 8d + 2t + {0, 1}:
  // each lane quad writes one 32-byte sector of a row
  float* obase = out + ((int64_t)b * H + wp * WS) * W * C
                 + (int64_t)wq * WS * C + h * HD + 2 * t;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    *(float2*)(obase + pixel(r0) * C + 8 * d) = make_float2(o[d][0], o[d][1]);
    *(float2*)(obase + pixel(r0 + 8) * C + 8 * d) =
        make_float2(o[d][2], o[d][3]);
  }
}

template <int WS, int HD, int MINB>
int launch(const float* qkv, const float* bias, const int32_t* labels,
           float* out, int B, int H, int W, int C, int nh, float scale,
           cudaStream_t stream) {
  using G = Geometry<WS, HD>;
  const size_t smem = sizeof(float) * (size_t)G::FLOATS;
  auto kernel = window_attention_kernel<WS, HD, MINB>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int nW = (H / WS) * (W / WS);
  kernel<<<B * nW * nh, G::TEAM, smem, stream>>>(qkv, bias, labels, out, H, W,
                                                 C, nh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// 1 when (N, hd) has a compiled instance, else 0: WACNN's two geometries,
// 8x8 windows at head width 24 and 4x4 windows at head width 40, and
// STF's, 4x4 windows at head width 16. Each instance unrolls its tiles
// fully and costs build time, so only shapes a ported model runs are
// compiled.
int stf_window_attention_supported(int32_t n, int32_t hd) {
  return (n == 64 && hd == 24) || (n == 16 && hd == 40) ||
         (n == 16 && hd == 16);
}

// qkv: (B, H, W, 3C) f32; bias: (nh, N, N) f32; labels: (nW, N) int32 or
// null; out: (B, H, W, C) f32; qkv and out 16-byte aligned, bias 8. Launches on
// `stream`, returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported shape or a misaligned pointer).
int stf_window_attention(const void* qkv, const void* bias,
                         const void* labels, void* out, int32_t B, int32_t H,
                         int32_t W, int32_t ws, int32_t C, int32_t nh,
                         float scale, void* stream) {
  const float* q = (const float*)qkv;
  const float* bs = (const float*)bias;
  const int32_t* lb = (const int32_t*)labels;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if ((uintptr_t)qkv % 16 || (uintptr_t)out % 16 || (uintptr_t)bias % 8)
    return (int)cudaErrorInvalidValue;
  const int n = ws * ws, hd = C / nh;
  if (n == 64 && hd == 24)
    return launch<8, 24, 6>(q, bs, lb, o, B, H, W, C, nh, scale, st);
  if (n == 16 && hd == 40)
    return launch<4, 40, 8>(q, bs, lb, o, B, H, W, C, nh, scale, st);
  if (n == 16 && hd == 16)
    return launch<4, 16, 32>(q, bs, lb, o, B, H, W, C, nh, scale, st);
  return (int)cudaErrorInvalidValue;
}

const char* stf_window_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
