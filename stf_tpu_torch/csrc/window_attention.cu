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

// Head widths that are not a multiple of 8 (TBC's 4, 6 and 10 at 8x8
// windows and 6 at 4x4; TBC's 8 too) run the same tiles on the head padded
// to HDP, the next multiple of 8: the staging copies the HD real columns
// of q, k and v (16-, 8- or 4-byte cp.async, the largest that divides a
// head's slice of a row, since h * HD floats is only 8-byte aligned at
// hd 6 and 10) and zeroes the HDP - HD others in shared memory. Zero
// columns add nothing to q . k^T; P . v computes HDP output columns and
// the store drops the padding ones (HD is even, so a lane's column pair
// is kept or dropped whole). Rows stay HDP + 4 floats (f32) or the bf16
// pitch below, so the fragment loads keep their 32 distinct banks. At
// hd 4 half of every m16n8k8 tile multiplies zeros.
//
// TBC's 8x8 geometries (32 heads of 4-10 channels) run a second design,
// the head group's (`window_attention_head_group_kernel` below), which
// the wrapper launches there; the window-head instances above stay
// callable at those widths (`_launch(..., design=...)`) so that one call
// on the card times both. Why a second design: at hd 4 a (window, head)
// is 64 x 64 x 4 products, so one block per (window, head) spent its time
// around them: 98,304 blocks at TBC's stage 0, each staging 3 KB in half
// sectors, zero-filling padding, re-reading its 16 KB bias from L2 in both
// softmax passes and comparing labels on every logit, with 128-register
// warps at 16 an SM. The head-group design keeps one block per (2 heads,
// run of windows) resident: it reads the bias once, stages whole sectors
// of both heads with one barrier a window, decides the penalty once a
// window, computes the window walk by carries instead of divisions,
// exponentiates with ex2 on pre-scaled logits (two FFMAs in f32, one in
// bf16, each as exact as the f32 kernel's rounding of bias - max) and
// uses m16n8k4 for q . k^T at hd 4. It is issue-bound (~500 instructions a
// warp a window at hd 4): 2.2x the window-head design in f32 and 2.1x in
// bf16 at stage 0 on an H100 (PERF.md section 6).

#include <cuda_bf16.h>
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

// cp.async of BYTES = 4, 8 or 16 (.cg takes only 16; .ca the others).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  if constexpr (BYTES == 16) {
    cp_async16(smem_dst, src);
  } else {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
  }
}

// Elements a staging copy moves: the largest of MAX, MAX / 2 and MAX / 4
// (MAX = the elements of 16 bytes) that divides HD, since a head's slice
// starts h * HD elements into a 16-byte aligned row.
template <int HD, int MAX>
constexpr int chunk_elems() {
  return HD % MAX == 0 ? MAX : HD % (MAX / 2) == 0 ? MAX / 2 : MAX / 4;
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
  static constexpr int HDP = (HD + 7) / 8 * 8;  // the head padded to tiles
  static constexpr int QP = HDP + 4;
  static constexpr int FLOATS = 3 * N * QP;
  static constexpr int CE = chunk_elems<HD, 4>();  // floats a staging copy
  static_assert(N % 16 == 0, "m16n8k8 tiles");
  static_assert(HD % 2 == 0 && CE >= 2, "even head widths (float2 stores)");
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
  constexpr int N = G::N, TEAM = G::TEAM, QP = G::QP, HDP = G::HDP;
  constexpr int CE = G::CE, CH = HD / CE;  // copies a token
  constexpr int NT = N / 8, DT = HDP / 8;  // 8-wide tiles of keys and of hd
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
  // hd / CE copies of CE floats each; S waits for the first group only.
  // The padding columns [HD, HDP) are zeroed by plain stores
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    for (int e = tid; e < N * CH; e += TEAM) {
      const int n = e / CH, c = e - n * CH;
      cp_async<4 * CE>(smem + which * N * QP + n * QP + CE * c,
                       base + pixel(n) * C3 + which * C + CE * c);
    }
    if (which != 0) asm volatile("cp.async.commit_group;\n" ::);
  }
  if constexpr (HDP != HD) {
    for (int e = tid; e < 3 * N * (HDP - HD); e += TEAM) {
      const int row = e / (HDP - HD);
      smem[row * QP + HD + (e - row * (HDP - HD))] = 0.f;
    }
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
  for (int kk = 0; kk < DT; ++kk) {
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
  // each lane quad writes one 32-byte sector of a row; padding channels
  // (8d + 2t >= HD) are not stored
  float* obase = out + ((int64_t)b * H + wp * WS) * W * C
                 + (int64_t)wq * WS * C + h * HD + 2 * t;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (HDP != HD && 8 * d + 2 * t >= HD) continue;
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

// ---------------------------------------------------------------------------
// The bf16 instances: the same core on bf16 qkv, bias and output, as the
// JAX codec runs its analysis transforms in bf16 (`Codec(dtype=bf16)`).
// What they compute is what the JAX core computes in its inputs' dtype
// (stf_tpu/layers/win_attention.py:183-202, pallas_attention.py:49-67):
//   qs = bf16(q * bf16(scale))        (the product rounded to bf16; the
//                                      scale, a weak Python float there,
//                                      is rounded to bf16 first: the
//                                      wrapper passes it rounded)
//   s  = qs . k^T                      (bf16 products, exact in f32,
//                                      summed in f32)
//   l  = (s + bias) + penalty          (f32; bias a bf16 parameter)
//   P  = softmax(l)                    (f32)
//   out = bf16(P . v)                  (P stays f32: v is promoted)
// The kernel reads bf16 qkv and writes bf16 out itself: no cast pass
// over device memory. Two designs for the products, both kept so that
// one call on the card times them side by side (PERF.md section 6):
//   * BMMA: q.k^T on bf16 mma.sync m16n8k16 (m16n8k8 for the last 8
//     of hd 24 and 40), exact products; P.v with P split into three
//     bf16 parts (high, middle, low), three bf16 mmas that keep 24 bits
//     of each P. Two parts (16 bits) measured 1.5 bf16 ulps from the
//     plain version at 8x8 / hd 24 on an H100: a P error of 2^-17 is
//     more than an ulp of an output that cancels. S's accumulator tiles
//     are the A fragments of P.v as they stand (two n-tiles make one
//     16-key k-tile), so P never touches shared memory;
//   * TF32: the bf16 values converted in registers feed the f32
//     kernel's mma.sync m16n8k8 TF32 tiles. A bf16 value is a TF32 value,
//     so q.k^T takes one TF32 mma per 8 x 8 x 8 tile and P.v two (P
//     split into TF32 big + small): about 1.4x the mma operations of
//     BMMA.
// Shared memory holds q, k and v as staged (bf16, 16-byte cp.async),
// rows of QP bf16: QP / 2 words a row is 4 x an odd number, so the
// fragment loads (8 rows x 4 words a warp) hit 32 distinct banks. The
// bytes bound it as in f32 (2 bytes an element instead of 4); the
// softmax and staging latency are the rest, as there.

template <int WS, int HD>
struct Bf16Geometry {
  static constexpr int N = WS * WS;
  static constexpr int TEAM = 2 * N;  // N / 16 warps
  static constexpr int HDP = (HD + 7) / 8 * 8;  // the head padded to tiles
  static constexpr int QP = ((HDP / 8) % 2 == 1) ? HDP : HDP + 8;
  static constexpr int ELEMS = 3 * N * QP;
  static constexpr int CE = chunk_elems<HD, 8>();  // bf16s a staging copy
  static_assert(N % 16 == 0, "m16n8k8 tiles");
  static_assert(HD % 2 == 0 && CE >= 2, "even head widths (bf16 pairs)");
};

__device__ __forceinline__ float bf16_bits_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_bits_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// bf16(x * scale) as an f32 value
__device__ __forceinline__ float scaled_bf16(float x, float scale) {
  return __bfloat162float(__float2bfloat16_rn(x * scale));
}

// d += a . b on one m16n8k16 bf16 tile, f32 accumulation.
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on one m16n8k8 bf16 tile, f32 accumulation.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// One block per (window, head), as the f32 kernel; lane (g, t) holds rows
// r0 = 16 warp + g and r0 + 8 of S and of the output.
template <int WS, int HD, int MINB, bool BMMA>
__global__ void __launch_bounds__(Bf16Geometry<WS, HD>::TEAM, MINB)
window_attention_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ bias,
                             const int32_t* __restrict__ labels,
                             __nv_bfloat16* __restrict__ out, int H, int W,
                             int C, int nh, float scale) {
  using G = Bf16Geometry<WS, HD>;
  constexpr int N = G::N, TEAM = G::TEAM, QP = G::QP, HDP = G::HDP;
  constexpr int CE = G::CE, CH = HD / CE;  // copies a token
  constexpr int NT = N / 8, DT = HDP / 8;
  extern __shared__ __align__(16) __nv_bfloat16 bsmem[];
  __nv_bfloat16* qs = bsmem;
  __nv_bfloat16* ks = qs + N * QP;
  __nv_bfloat16* vs = ks + N * QP;

  const int h = blockIdx.x % nh;
  const int bw = blockIdx.x / nh;
  const int Q = W / WS;
  const int nW = (H / WS) * Q;
  const int win = bw % nW, b = bw / nW;
  const int wp = win / Q, wq = win - wp * Q;
  const int64_t C3 = 3 * (int64_t)C;
  const int tid = threadIdx.x;
  const __nv_bfloat16* base = qkv + ((int64_t)b * H + wp * WS) * W * C3
                              + (int64_t)wq * WS * C3 + h * HD;
  auto pixel = [&](int n) { return (int64_t)(n / WS) * W + n % WS; };

  // q and k in one cp.async group, v in a second: hd / CE copies of CE
  // bf16s a token; the padding columns [HD, HDP) zeroed by plain stores
#pragma unroll
  for (int which = 0; which < 3; ++which) {
    for (int e = tid; e < N * CH; e += TEAM) {
      const int n = e / CH, c = e - n * CH;
      cp_async<2 * CE>(bsmem + which * N * QP + n * QP + CE * c,
                       base + pixel(n) * C3 + which * C + CE * c);
    }
    if (which != 0) asm volatile("cp.async.commit_group;\n" ::);
  }
  if constexpr (HDP != HD) {
    for (int e = tid; e < 3 * N * (HDP - HD); e += TEAM) {
      const int row = e / (HDP - HD);
      bsmem[row * QP + HD + (e - row * (HDP - HD))] = __float2bfloat16(0.f);
    }
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (tid >> 5) * 16 + g;

  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  if constexpr (BMMA) {
    // A: q rows r0, r0 + 8 at columns 2t, 2t + 1 (+8), scaled and rounded
    // to bf16 in registers; B: k row 8n + g at the same columns
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qs);
    const uint32_t* k32 = reinterpret_cast<const uint32_t*>(ks);
    auto qpair = [&](int row, int col) {
      const uint32_t w = q32[(row * QP + col) / 2];
      return pack_bf16x2(bf16_bits_lo(w) * scale, bf16_bits_hi(w) * scale);
    };
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const int c0 = 16 * kk + 2 * t;
      const uint32_t a[4] = {qpair(r0, c0), qpair(r0 + 8, c0),
                             qpair(r0, c0 + 8), qpair(r0 + 8, c0 + 8)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int kr = (8 * n + g) * QP;
        mma_bf16_k16(s[n], a, k32[(kr + c0) / 2], k32[(kr + c0 + 8) / 2]);
      }
    }
    if constexpr (HDP % 16 != 0) {
      const int c0 = HDP - 8 + 2 * t;
      const uint32_t a0 = qpair(r0, c0), a1 = qpair(r0 + 8, c0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma_bf16_k8(s[n], a0, a1, k32[((8 * n + g) * QP + c0) / 2]);
    }
  } else {
    // the f32 kernel's TF32 tiles on the converted values: a bf16 value
    // is exact in TF32, so one mma a tile
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      const __nv_bfloat16* q0 = qs + r0 * QP + 8 * kk + t;
      const uint32_t a[4] = {
          __float_as_uint(scaled_bf16(bf16_at(q0), scale)),
          __float_as_uint(scaled_bf16(bf16_at(q0 + 8 * QP), scale)),
          __float_as_uint(scaled_bf16(bf16_at(q0 + 4), scale)),
          __float_as_uint(scaled_bf16(bf16_at(q0 + 8 * QP + 4), scale))};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* k0 = ks + (8 * n + g) * QP + 8 * kk + t;
        mma_tf32(s[n], a, __float_as_uint(bf16_at(k0)),
                 __float_as_uint(bf16_at(k0 + 4)));
      }
    }
  }

  // logits (s + bias) + penalty in f32, in JAX's order, then the row
  // softmax across the 4 lanes of a row
  const __nv_bfloat16* brow = bias + ((int64_t)h * N + r0) * N + 2 * t;
  const int32_t* lab = labels != nullptr ? labels + (int64_t)win * N : nullptr;
  const int li0 = lab != nullptr ? __ldg(lab + r0) : 0;
  const int li1 = lab != nullptr ? __ldg(lab + r0 + 8) : 0;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 b0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(brow + 8 * n));
    const float2 b1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(brow + 8 * N + 8 * n));
    const float bv[4] = {b0.x, b0.y, b1.x, b1.y};
    const int lj0 = lab != nullptr ? __ldg(lab + 8 * n + 2 * t) : 0;
    const int lj1 = lab != nullptr ? __ldg(lab + 8 * n + 2 * t + 1) : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = s[n][i] + bv[i];
      if ((i & 1 ? lj1 : lj0) != (i < 2 ? li0 : li1)) v += -100.f;
      s[n][i] = v;
      if (i < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
  }
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = expf(s[n][0] - mx0);
    s[n][1] = expf(s[n][1] - mx0);
    s[n][2] = expf(s[n][2] - mx1);
    s[n][3] = expf(s[n][3] - mx1);
    sum0 += s[n][0] + s[n][1];
    sum1 += s[n][2] + s[n][3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sum0 += __shfl_xor_sync(kFull, sum0, o);
    sum1 += __shfl_xor_sync(kFull, sum1, o);
  }
  const float rinv0 = 1.f / sum0, rinv1 = 1.f / sum1;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] *= rinv0;
    s[n][1] *= rinv0;
    s[n][2] *= rinv1;
    s[n][3] *= rinv1;
  }

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  const unsigned short* v16 = reinterpret_cast<const unsigned short*>(vs);
  // v[key][channel 8d + g] as a bf16 pair of keys (key, key + 1), low
  // half the first
  auto vpair = [&](int key, int d) {
    const int at = key * QP + 8 * d + g;
    return (uint32_t)v16[at] | ((uint32_t)v16[at + QP] << 16);
  };
  if constexpr (BMMA) {
    // k-tile j of P . v is S's n-tiles 2j (keys 2t, 2t + 1) and 2j + 1
    // (keys 2t + 8, 2t + 9); P = hi + mid + lo, each bf16
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t hi[4], mid[4], lo[4];
      const float pa[4][2] = {{s[2 * j][0], s[2 * j][1]},
                              {s[2 * j][2], s[2 * j][3]},
                              {s[2 * j + 1][0], s[2 * j + 1][1]},
                              {s[2 * j + 1][2], s[2 * j + 1][3]}};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hi[r] = pack_bf16x2(pa[r][0], pa[r][1]);
        const float r0 = pa[r][0] - bf16_bits_lo(hi[r]);
        const float r1 = pa[r][1] - bf16_bits_hi(hi[r]);
        mid[r] = pack_bf16x2(r0, r1);
        lo[r] = pack_bf16x2(r0 - bf16_bits_lo(mid[r]),
                            r1 - bf16_bits_hi(mid[r]));
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const uint32_t b0 = vpair(16 * j + 2 * t, d);
        const uint32_t b1 = vpair(16 * j + 2 * t + 8, d);
        mma_bf16_k16(o[d], lo, b0, b1);
        mma_bf16_k16(o[d], mid, b0, b1);
        mma_bf16_k16(o[d], hi, b0, b1);
      }
    }
  } else {
    // the f32 kernel's permuted-key P . v: fragment column t <-> key 2t,
    // t + 4 <-> key 2t + 1 of tile n; P split into TF32 big + small, v
    // exact in TF32
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ab[4], as[4];
      split_tf32(s[n][0], ab[0], as[0]);
      split_tf32(s[n][2], ab[1], as[1]);
      split_tf32(s[n][1], ab[2], as[2]);
      split_tf32(s[n][3], ab[3], as[3]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const uint32_t vp = vpair(8 * n + 2 * t, d);
        const uint32_t vb0 = __float_as_uint(bf16_bits_lo(vp));
        const uint32_t vb1 = __float_as_uint(bf16_bits_hi(vp));
        mma_tf32(o[d], as, vb0, vb1);
        mma_tf32(o[d], ab, vb0, vb1);
      }
    }
  }

  // rows r0 and r0 + 8, channels 8d + 2t + {0, 1}, as bf16 pairs; padding
  // channels (8d + 2t >= HD) are not stored
  __nv_bfloat16* obase = out + ((int64_t)b * H + wp * WS) * W * C
                         + (int64_t)wq * WS * C + h * HD + 2 * t;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    if (HDP != HD && 8 * d + 2 * t >= HD) continue;
    *reinterpret_cast<__nv_bfloat162*>(obase + pixel(r0) * C + 8 * d) =
        __floats2bfloat162_rn(o[d][0], o[d][1]);
    *reinterpret_cast<__nv_bfloat162*>(obase + pixel(r0 + 8) * C + 8 * d) =
        __floats2bfloat162_rn(o[d][2], o[d][3]);
  }
}

template <int WS, int HD, int MINB, bool BMMA>
int launch_bf16(const __nv_bfloat16* qkv, const __nv_bfloat16* bias,
                const int32_t* labels, __nv_bfloat16* out, int B, int H,
                int W, int C, int nh, float scale, cudaStream_t stream) {
  using G = Bf16Geometry<WS, HD>;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)G::ELEMS;
  const int nW = (H / WS) * (W / WS);
  window_attention_bf16_kernel<WS, HD, MINB, BMMA>
      <<<B * nW * nh, G::TEAM, smem, stream>>>(qkv, bias, labels, out, H, W,
                                               C, nh, scale);
  return (int)cudaGetLastError();
}

// The compiled (window, head width, __launch_bounds__ minimum blocks)
// instances, f32 and bf16 alike: WACNN's 8x8 windows at head width 24
// and 4x4 at 40; STF's and DYSTF's 4x4 at 16; TBC's 8x8 at 4, 6, 8 and 10
// (32 heads over widths 128-320) and 4x4 at 6 (its hyper stacks, 32
// heads over 192). Any other geometry is refused (cudaErrorInvalidValue).
#define STF_INSTANCES(X) \
  X(8, 24, 6)            \
  X(4, 40, 8)            \
  X(4, 16, 32)           \
  X(8, 4, 6)             \
  X(8, 6, 6)             \
  X(8, 8, 6)             \
  X(8, 10, 6)            \
  X(4, 6, 32)

template <bool BMMA>
int launch_bf16_geometry(const __nv_bfloat16* q, const __nv_bfloat16* bs,
                         const int32_t* lb, __nv_bfloat16* o, int B, int H,
                         int W, int ws, int C, int nh, float scale,
                         cudaStream_t st) {
  const int n = ws * ws, hd = C / nh;
#define STF_BF16(WS_, HD_, MINB_)                                            \
  if (n == WS_ * WS_ && hd == HD_)                                           \
    return launch_bf16<WS_, HD_, MINB_, BMMA>(q, bs, lb, o, B, H, W, C, nh,  \
                                              scale, st);
  STF_INSTANCES(STF_BF16)
#undef STF_BF16
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The head-group design (TBC's 8x8 windows at head widths 4, 6, 8 and 10,
// 32 heads; f32 and bf16). See the header comment for why it exists. A
// block owns G = 2 heads (4 row-block warps a head: warp w is head w / 4,
// query rows 16 (w % 4) .. + 15) and walks windows: window i of block
// chunk c is i * chunks + (c + i) % chunks (`chunks` from the host, one
// wave), so that at step i every block is in the same run of `chunks`
// windows and the windows of a column (TBC's mixed last column) fall on
// every chunk in turn; (b, wp, wq) follow the walk by carries, without a
// division. The next window's q, k, v (the group's G * HD contiguous
// elements a token, 16-byte cp.async) and its 64 labels are staged while
// this one computes (two buffers, one __syncthreads a window). Rows are
// padded to P elements (P / 4 odd in f32, P / 8 odd in bf16), so the
// fragment loads hit 32 distinct banks. The bias is read once a block: in
// f32 into shared memory (rows of BP = 72, conflict-free float2 reads),
// which leaves 80 registers a thread and 24 warps an SM; in bf16 into 32
// registers a warp's fragment (16 warps an SM), which measured faster
// there. The window's labels decide, by one warp vote, whether any label
// differs; only such a window (a shifted map's last row and column) runs
// the label compares and the TwoSum. The settings below were chosen on an
// H100 (PERF.md section 6, tools/compare_window_attention.py builds
// others with -D).

#ifndef WINATTN_HG_GROUP
#define WINATTN_HG_GROUP 2  // heads a block
#endif
#ifndef WINATTN_HG_STAMPS
#define WINATTN_HG_STAMPS 0  // 1: block 0's warps sum clock64() by phase
#endif
#if WINATTN_HG_STAMPS
__device__ unsigned long long hg_stamps[32 * 8];
#endif

template <typename T, int HD, int G>
struct HeadGroupGeometry {
  static constexpr int WS = 8, N = 64;
  static constexpr int TEAM = 32 * 4 * G;
  // f32 keeps the bias in shared memory, which frees the 32 registers a
  // thread its fragment takes for 24 warps an SM; bf16 keeps it in
  // registers at 16 warps an SM (each measured the faster for its type)
  static constexpr bool BIAS_SMEM = sizeof(T) == 4;
  static constexpr int MINB = BIAS_SMEM ? (G >= 6 ? 1 : 6 / G)
                                        : (G >= 4 ? 1 : 4 / G);
  static constexpr int ROW = G * HD;                // a token's slice
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements of 16 bytes
  static constexpr int CE = chunk_elems<ROW, EPC>();  // elements a copy
  static constexpr int CPR = ROW / CE;              // copies a slice
  static constexpr int P0 = (ROW + EPC - 1) / EPC * EPC;
  static constexpr int P = (P0 / EPC) % 2 == 1 ? P0 : P0 + EPC;
  static constexpr int TILE = 3 * N * P;            // q, k, v of a window
  static constexpr int BUF = TILE * (int)sizeof(T) + N * 4;  // + labels
  static constexpr int BP = 72;  // bias row pitch in shared memory
  static constexpr int BIAS = BIAS_SMEM ? G * N * BP * (int)sizeof(T) : 0;
  static constexpr int SMEM = 2 * BUF + BIAS;
  static_assert(HD % 2 == 0 && CE >= 2, "even head widths");
  static_assert(BUF % 16 == 0, "16-byte aligned buffers");
};

// x = big + small for 3xTF32 (or 2 terms in bf16): big is x rounded to
// TF32 (its low 13 bits cleared), small the exact rest, which the tensor
// core reads as TF32 by ignoring its low 13 bits.
// With TRUNC, big is x as it stands (the tensor core truncates it to
// TF32) and small the rest after the truncation: one instruction fewer,
// and about one bit less of each product (the bf16 P split uses it).
template <bool TRUNC = false>
__device__ __forceinline__ void split_tf32_rest(float x, uint32_t& big,
                                                uint32_t& small) {
  if constexpr (TRUNC) {
    big = __float_as_uint(x);
    small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
  } else {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
  }
}

// d += a . b on one m16n8k4 TF32 tile: a0 = A[g][t], a1 = A[g + 8][t],
// b0 = B[t][g].
__device__ __forceinline__ void mma_tf32_k4(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.44269504088896341f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// What it computes is what the window-head kernels compute: in f32 the
// same two-pass softmax (pass 2 forms fma(s, scale, bias - m) where the
// window's labels are uniform, the TwoSum form of the f32 kernel where
// they are not) on 3xTF32 products; in bf16 the rounding specification
// above, q.k^T on bf16 mma.sync (exact products) and P.v on TF32 with P in
// two parts and v exact. Both take the softmax's 1 / sum after P.v.
template <typename T, int HD, int G>
__global__ void __launch_bounds__(HeadGroupGeometry<T, HD, G>::TEAM,
                                  HeadGroupGeometry<T, HD, G>::MINB)
window_attention_head_group_kernel(const T* __restrict__ qkv,
                                   const T* __restrict__ bias,
                                   const int32_t* __restrict__ labels,
                                   T* __restrict__ out, int B, int H, int W,
                                   int C, int nh, int chunks, float scale) {
  using Geo = HeadGroupGeometry<T, HD, G>;
  constexpr int WS = Geo::WS, N = Geo::N, P = Geo::P, TEAM = Geo::TEAM;
  constexpr int CE = Geo::CE, CPR = Geo::CPR, ROW = Geo::ROW;
  constexpr int DT = (HD + 7) / 8;  // 8-wide output tiles
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char hg_smem[];

  const int groups = nh / G;
  const int hgrp = blockIdx.x % groups, chunk = blockIdx.x / groups;
  const int Q = W / WS, nW = (H / WS) * Q, total = B * nW;
  const int64_t C3 = 3 * (int64_t)C;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int hl = tid >> 7;                     // head in the group
  const int r0 = ((tid >> 5) & 3) * 16 + g;    // rows r0 and r0 + 8
  const int h = hgrp * G + hl;
  // row r0's offset in a window's output (row r0 + 8 is W C further)
  const unsigned row0 = ((unsigned)(r0 / WS) * W + r0 % WS) * (unsigned)C;
#if WINATTN_HG_STAMPS
  __shared__ unsigned long long stamp_sum[32 * 8];
  for (int k = tid; k < 32 * 8; k += TEAM) stamp_sum[k] = 0;
  __syncthreads();
  long long last = clock64();
#define HG_STAMP(k)                                                   \
  if (lane == 0) {                                                    \
    const long long now = clock64();                                  \
    stamp_sum[((tid >> 5) & 31) * 8 + (k)] += now - last;             \
    last = now;                                                       \
  }
#else
#define HG_STAMP(k)
#endif

  auto tile = [&](int i) {
    return reinterpret_cast<T*>(hg_smem + (i & 1) * Geo::BUF);
  };
  auto tile_labels = [&](int i) {
    return reinterpret_cast<int32_t*>(hg_smem + (i & 1) * Geo::BUF +
                                      Geo::TILE * (int)sizeof(T));
  };
  const int full = total / chunks, rest = total - full * chunks;
  const int count = full + ((chunk + full) % chunks < rest ? 1 : 0);
  // the walk: step i takes window i chunks + (chunk + i) % chunks, so the
  // next step is chunks + 1 windows on, or 1 where the position wraps;
  // (b, wp, wq) follow by carries, without a division. locate() returns
  // the step's window index in its image and its top-left pixel
  // (b H + 8 wp) W + 8 wq, and moves to the next step
  const int R = H / WS;  // rows of windows
  int pos = chunk, win_b = 0, win_p = 0, win_q = chunk;
  while (win_q >= Q) win_q -= Q, ++win_p;
  while (win_p >= R) win_p -= R, ++win_b;
  auto locate = [&](int& win) -> int64_t {
    win = win_p * Q + win_q;
    const int64_t pix = ((int64_t)win_b * H + win_p * WS) * W + win_q * WS;
    const int step = pos + 1 == chunks ? 1 : chunks + 1;
    pos = pos + 1 == chunks ? 0 : pos + 1;
    win_q += step;
    while (win_q >= Q) win_q -= Q, ++win_p;
    while (win_p >= R) win_p -= R, ++win_b;
    return pix;
  };
  // a window's copies: COPIES of SCE elements, the same offsets in every
  // window (32-bit: the host keeps 8 W 3C below 2^31)
  constexpr unsigned COPIES = 3 * N * CPR;
  const unsigned wc3 = (unsigned)W * (unsigned)C3;
  auto stage = [&](int i, int64_t pix, int win) {
    const T* base = qkv + pix * C3 + hgrp * ROW;
    T* dst = tile(i);
#pragma unroll
    for (unsigned k = 0; k < (COPIES + TEAM - 1) / TEAM; ++k) {
      const unsigned e = tid + k * TEAM;
      if (COPIES % TEAM == 0 || e < COPIES) {
        const unsigned which = e / (N * CPR), rem = e % (N * CPR);
        const unsigned n = rem / CPR, c = rem % CPR;
        cp_async<CE * (int)sizeof(T)>(
            dst + (which * N + n) * P + c * CE,
            base + ((n / WS) * wc3 + (n % WS) * (unsigned)C3 +
                    which * (unsigned)C + c * CE));
      }
    }
    if (labels != nullptr && tid < N / 4)
      cp_async16(tile_labels(i) + 4 * tid, labels + (int64_t)win * N + 4 * tid);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  int64_t pix = 0;  // window i's top-left pixel
  if (count > 0) {
    if constexpr (Geo::BIAS > 0) {  // in window 0's copy group
      constexpr int EPC = Geo::EPC, RC = N / EPC;  // 16-byte copies a row
      T* bdst = reinterpret_cast<T*>(hg_smem + 2 * Geo::BUF);
      const T* bsrc = bias + (int64_t)hgrp * G * N * N;
      for (int e = tid; e < G * N * RC; e += TEAM)
        cp_async16(bdst + (e / RC) * Geo::BP + (e % RC) * EPC,
                   bsrc + (e / RC) * N + (e % RC) * EPC);
    }
    int win;
    pix = locate(win);
    stage(0, pix, win);
  }

  // this warp's bias fragment: rows r0, r0 + 8; keys 8n + 2t, 8n + 2t + 1:
  // in 32 registers, or (BIASSMEM) the group's bias staged once into
  // shared memory (rows of BP elements) and read in each pass
  constexpr bool BIASSMEM = Geo::BIAS_SMEM;  // (see the geometry)
  float bv[BIASSMEM ? 1 : 8][4];
  const T* bsm = reinterpret_cast<const T*>(hg_smem + 2 * Geo::BUF) +
                 (hl * N + r0) * Geo::BP + 2 * t;
  if constexpr (!BIASSMEM) {
    const T* brow = bias + ((int64_t)h * N + r0) * N + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 b0 = pair_f32(brow + 8 * n);
      const float2 b1 = pair_f32(brow + 8 * N + 8 * n);
      bv[n][0] = b0.x, bv[n][1] = b0.y, bv[n][2] = b1.x, bv[n][3] = b1.y;
    }
  }
  auto bias4 = [&](int n, float (&b)[4]) {
    if constexpr (BIASSMEM) {
      const float2 b0 = pair_f32(bsm + 8 * n);
      const float2 b1 = pair_f32(bsm + 8 * Geo::BP + 8 * n);
      b[0] = b0.x, b[1] = b0.y, b[2] = b1.x, b[3] = b1.y;
    } else {
      b[0] = bv[n][0], b[1] = bv[n][1], b[2] = bv[n][2], b[3] = bv[n][3];
    }
  };

  for (int i = 0; i < count; ++i) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // window i landed; window i - 1's tile is free
    HG_STAMP(0)
    int next_win = 0;
    const int64_t next_pix = i + 1 < count ? locate(next_win) : 0;
    if (i + 1 < count) stage(i + 1, next_pix, next_win);
    HG_STAMP(1)
    const T* qs = tile(i) + hl * HD;
    const T* ks = qs + N * P;
    const T* vs = ks + N * P;
    const int32_t* lab = tile_labels(i);
    bool uniform = true;
    if (labels != nullptr) {
      const int l0 = lab[0];
      uniform = __all_sync(kFull, lab[lane] == l0 && lab[lane + 32] == l0);
    }
    HG_STAMP(2)

    // S = q k^T for the warp's 16 rows, 8 tiles of 16 x 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
    if constexpr (!BF16) {
      // columns past HD read as 0: k8 steps, and k4 for a last 2 or 4
      auto at = [&](const T* m, int row, int col) {
        return col < HD ? to_f32(m[row * P + col]) : 0.f;
      };
#pragma unroll
      for (int c0 = 0; c0 < HD; c0 += 8) {
        if (HD - c0 > 4) {
          uint32_t ab[4], as[4];
          split_tf32_rest(at(qs, r0, c0 + t), ab[0], as[0]);
          split_tf32_rest(at(qs, r0 + 8, c0 + t), ab[1], as[1]);
          split_tf32_rest(at(qs, r0, c0 + t + 4), ab[2], as[2]);
          split_tf32_rest(at(qs, r0 + 8, c0 + t + 4), ab[3], as[3]);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            uint32_t kb0, ks0, kb1, ks1;
            split_tf32_rest(at(ks, 8 * n + g, c0 + t), kb0, ks0);
            split_tf32_rest(at(ks, 8 * n + g, c0 + t + 4), kb1, ks1);
            mma_tf32(s[n], as, kb0, kb1);
            mma_tf32(s[n], ab, ks0, ks1);
            mma_tf32(s[n], ab, kb0, kb1);
          }
        } else {
          uint32_t ab0, as0, ab1, as1;
          split_tf32_rest(at(qs, r0, c0 + t), ab0, as0);
          split_tf32_rest(at(qs, r0 + 8, c0 + t), ab1, as1);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            uint32_t kb, kr;
            split_tf32_rest(at(ks, 8 * n + g, c0 + t), kb, kr);
            mma_tf32_k4(s[n], as0, as1, kb);
            mma_tf32_k4(s[n], ab0, ab1, kr);
            mma_tf32_k4(s[n], ab0, ab1, kb);
          }
        }
      }
    } else {
      // bf16 pairs (col, col + 1) as words, 0 past HD; q scaled and
      // rounded to bf16: k16 steps, and k8 for a last 8 or fewer
      auto word = [&](const T* m, int row, int col) -> uint32_t {
        return col < HD ? *reinterpret_cast<const uint32_t*>(m + row * P + col)
                        : 0u;
      };
      auto qword = [&](int row, int col) -> uint32_t {
        const uint32_t w = word(qs, row, col);
        return pack_bf16x2(bf16_bits_lo(w) * scale, bf16_bits_hi(w) * scale);
      };
#pragma unroll
      for (int c0 = 0; c0 < HD; c0 += 16) {
        if (HD - c0 > 8) {
          const uint32_t a[4] = {qword(r0, c0 + 2 * t), qword(r0 + 8, c0 + 2 * t),
                                 qword(r0, c0 + 2 * t + 8),
                                 qword(r0 + 8, c0 + 2 * t + 8)};
#pragma unroll
          for (int n = 0; n < 8; ++n)
            mma_bf16_k16(s[n], a, word(ks, 8 * n + g, c0 + 2 * t),
                         word(ks, 8 * n + g, c0 + 2 * t + 8));
        } else {
          const uint32_t a0 = qword(r0, c0 + 2 * t);
          const uint32_t a1 = qword(r0 + 8, c0 + 2 * t);
#pragma unroll
          for (int n = 0; n < 8; ++n)
            mma_bf16_k8(s[n], a0, a1, word(ks, 8 * n + g, c0 + 2 * t));
        }
      }
    }

    HG_STAMP(3)
    // softmax over the 4 lanes of a row; s[n][0..1] row r0, s[n][2..3]
    // row r0 + 8, keys 8n + 2t + {0, 1}. Labels are read only in a window
    // whose labels differ
    float mx0 = -INFINITY, mx1 = -INFINITY;
    const int li0 = uniform ? 0 : lab[r0], li1 = uniform ? 0 : lab[r0 + 8];
    auto differ = [&](int n, int j) {
      return lab[8 * n + 2 * t + (j & 1)] != (j < 2 ? li0 : li1);
    };
    // (two copies of the loop, so that a uniform window runs no label code)
    auto logits = [&](bool mixed) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float bn[4];
        bias4(n, bn);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = BF16 ? s[n][j] + bn[j] : fmaf(s[n][j], scale, bn[j]);
          if (mixed && differ(n, j)) v += -100.f;
          if (BF16) s[n][j] = v;
          if (j < 2) mx0 = fmaxf(mx0, v); else mx1 = fmaxf(mx1, v);
        }
      }
    };
    if (uniform)
      logits(false);
    else
      logits(true);
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, o));
    }
    HG_STAMP(4)
    // exponents in base 2 (ex2.approx): exp(x - m) = 2^(x log2(e) -
    // m log2(e)), the product x log2(e) exact inside an FFMA and the
    // rounding of m log2(e) a shift of the whole row, which the
    // normalisation cancels
    const float m0 = mx0 * kLog2e, m1 = mx1 * kLog2e;
    if (BF16) {  // exp(l - m) in one FFMA
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[n][j] = ex2_approx(fmaf(s[n][j], kLog2e, -(j < 2 ? m0 : m1)));
    } else if (uniform) {
      // 2^(s scale log2(e) + fma(b, log2(e), -m log2(e))): two FFMAs
      const float sl2e = scale * kLog2e;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float bn[4];
        bias4(n, bn);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[n][j] = ex2_approx(
              fmaf(s[n][j], sl2e, fmaf(bn[j], kLog2e, -(j < 2 ? m0 : m1))));
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float bn[4];
        bias4(n, bn);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // bias + penalty as the unevaluated sum hi + lo (TwoSum)
          float hi = bn[j], lo = 0.f;
          if (differ(n, j)) {
            hi = bn[j] + -100.f;
            const float bb = hi - bn[j];
            lo = (bn[j] - (hi - bb)) + (-100.f - bb);
          }
          s[n][j] = ex2_approx(
              ((hi - (j < 2 ? mx0 : mx1)) + fmaf(s[n][j], scale, lo)) * kLog2e);
        }
      }
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sum0 += __shfl_xor_sync(kFull, sum0, o);
      sum1 += __shfl_xor_sync(kFull, sum1, o);
    }
    const float rinv0 = 1.f / sum0, rinv1 = 1.f / sum1;
    HG_STAMP(5)

    // out = (e . v) / sum, rows r0 and r0 + 8 of the window at `pix`
    T* obase = out + pix * C + h * HD;
    auto at_row = [&](int r) {  // r is r0 or r0 + 8
      return obase + (r == r0 ? row0 : row0 + (unsigned)W * (unsigned)C);
    };
    // S's accumulator tile n is the A fragment of key tile n with the keys
    // permuted (column t <-> key 2t, t + 4 <-> 2t + 1), v's rows read in
    // the same order. ACC accumulators a tile, key tile n into n % ACC,
    // summed in order
    constexpr int ACC = 2;
    float oa[ACC][DT][4];
#pragma unroll
    for (int a = 0; a < ACC; ++a)
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int j = 0; j < 4; ++j) oa[a][d][j] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float (&o)[DT][4] = oa[n % ACC];
      // P's split truncates in bf16 (a 2^-21 error is far below bf16's)
      uint32_t ab[4], as[4];
      split_tf32_rest<BF16>(s[n][0], ab[0], as[0]);
      split_tf32_rest<BF16>(s[n][2], ab[1], as[1]);
      split_tf32_rest<BF16>(s[n][1], ab[2], as[2]);
      split_tf32_rest<BF16>(s[n][3], ab[3], as[3]);
      // v's channel 8d + g is output column g of tile d: past HD it reads
      // a neighbour's (finite) values into a column that is never stored
      const T* v0 = vs + (8 * n + 2 * t) * P + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float x0 = to_f32(v0[8 * d]);
        const float x1 = to_f32(v0[P + 8 * d]);
        if constexpr (BF16) {  // v is exact in TF32
          mma_tf32(o[d], as, __float_as_uint(x0), __float_as_uint(x1));
          mma_tf32(o[d], ab, __float_as_uint(x0), __float_as_uint(x1));
        } else {
          uint32_t vb0, vs0, vb1, vs1;
          split_tf32_rest(x0, vb0, vs0);
          split_tf32_rest(x1, vb1, vs1);
          mma_tf32(o[d], as, vb0, vb1);
          mma_tf32(o[d], ab, vs0, vs1);
          mma_tf32(o[d], ab, vb0, vb1);
        }
      }
    }
    float (&o)[DT][4] = oa[0];
#pragma unroll
    for (int a = 1; a < ACC; ++a)
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[d][j] += oa[a][d][j];
    HG_STAMP(6)
    // o[d][0..1] row r0, o[d][2..3] row r0 + 8, channels 8d + 2t + {0, 1}
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      if (8 * d + 2 * t >= HD) continue;
      store_pair(at_row(r0) + 8 * d + 2 * t, o[d][0] * rinv0, o[d][1] * rinv0);
      store_pair(at_row(r0 + 8) + 8 * d + 2 * t, o[d][2] * rinv1,
                 o[d][3] * rinv1);
    }
    pix = next_pix;
    HG_STAMP(7)
  }
#if WINATTN_HG_STAMPS
  if (blockIdx.x == 0 && lane == 0)
    for (int k = 0; k < 8; ++k)
      hg_stamps[((tid >> 5) & 31) * 8 + k] += stamp_sum[((tid >> 5) & 31) * 8 + k];
#endif
#undef HG_STAMP
}

template <typename T, int HD>
int launch_head_group(const T* qkv, const T* bias, const int32_t* labels,
                      T* out, int B, int H, int W, int C, int nh, int chunks,
                      float scale, cudaStream_t stream) {
  using Geo = HeadGroupGeometry<T, HD, WINATTN_HG_GROUP>;
  auto kernel = window_attention_head_group_kernel<T, HD, WINATTN_HG_GROUP>;
  if (Geo::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = nh / WINATTN_HG_GROUP;
  kernel<<<groups * chunks, Geo::TEAM, Geo::SMEM, stream>>>(
      qkv, bias, labels, out, B, H, W, C, nh, chunks, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int head_group_blocks_per_sm() {
  using Geo = HeadGroupGeometry<T, HD, WINATTN_HG_GROUP>;
  auto kernel = window_attention_head_group_kernel<T, HD, WINATTN_HG_GROUP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo::SMEM);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      Geo::TEAM, Geo::SMEM);
  return e == cudaSuccess ? blocks : -(int)e;
}

// The head-group instances: TBC's head widths at 8x8 windows.
#define STF_HEAD_GROUP_WIDTHS(X) X(4) X(6) X(8) X(10)

}  // namespace

extern "C" {

// 1 when (N, hd) has a compiled instance, else 0 (`STF_INSTANCES`). Each
// instance unrolls its tiles fully and costs build time, so only shapes a
// ported model runs are compiled.
int stf_window_attention_supported(int32_t n, int32_t hd) {
#define STF_HAS(WS_, HD_, MINB_) \
  if (n == WS_ * WS_ && hd == HD_) return 1;
  STF_INSTANCES(STF_HAS)
#undef STF_HAS
  return 0;
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
#define STF_F32(WS_, HD_, MINB_)    \
  if (n == WS_ * WS_ && hd == HD_) \
    return launch<WS_, HD_, MINB_>(q, bs, lb, o, B, H, W, C, nh, scale, st);
  STF_INSTANCES(STF_F32)
#undef STF_F32
  return (int)cudaErrorInvalidValue;
}

// The bf16 instances, at the same geometries: qkv (B, H, W, 3C), bias
// (nh, N, N) and out (B, H, W, C) bf16, labels as above; `scale` already
// rounded to bf16 by the caller; design 0 = BMMA (bf16 mma.sync, the
// codec's), 1 = TF32 on the converted values (kept for timing). qkv and out
// 16-byte aligned, bias 4.
int stf_window_attention_bf16(const void* qkv, const void* bias,
                              const void* labels, void* out, int32_t B,
                              int32_t H, int32_t W, int32_t ws, int32_t C,
                              int32_t nh, float scale, int32_t design,
                              void* stream) {
  const __nv_bfloat16* q = (const __nv_bfloat16*)qkv;
  const __nv_bfloat16* bs = (const __nv_bfloat16*)bias;
  const int32_t* lb = (const int32_t*)labels;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if ((uintptr_t)qkv % 16 || (uintptr_t)out % 16 || (uintptr_t)bias % 4)
    return (int)cudaErrorInvalidValue;
  if (design == 0)
    return launch_bf16_geometry<true>(q, bs, lb, o, B, H, W, ws, C, nh, scale,
                                      st);
  if (design == 1)
    return launch_bf16_geometry<false>(q, bs, lb, o, B, H, W, ws, C, nh,
                                       scale, st);
  return (int)cudaErrorInvalidValue;
}

#if WINATTN_HG_STAMPS
// Block 0's clock64() sums by (warp, phase) since the last call, then 0.
int stf_window_attention_head_group_stamps(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, hg_stamps, sizeof(hg_stamps));
  unsigned long long zero[32 * 8] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(hg_stamps, zero, sizeof(zero));
  return (int)e;
}
#endif

// Heads a block of the head-group design (the host's plan needs it).
int stf_window_attention_head_group_heads() { return WINATTN_HG_GROUP; }

// Blocks of the head-group instance (8x8 windows, head width hd; bf16 or
// f32) that fit on one SM at once; 0 for a width without one, minus a CUDA
// error code if the query failed.
int stf_window_attention_head_group_blocks(int32_t hd, int32_t bf16) {
#define STF_HG_BLOCKS(HD_)                                               \
  if (hd == HD_)                                                         \
    return bf16 ? head_group_blocks_per_sm<__nv_bfloat16, HD_>()         \
                : head_group_blocks_per_sm<float, HD_>();
  STF_HEAD_GROUP_WIDTHS(STF_HG_BLOCKS)
#undef STF_HG_BLOCKS
  return 0;
}

// The head-group design (see above) on f32 (bf16 = 0) or bf16 (bf16 = 1)
// qkv, bias and out, as `stf_window_attention` and
// `stf_window_attention_bf16` take them, for 8x8 windows, head widths 4,
// 6, 8 and 10 and heads a multiple of the group; `chunks` blocks a head
// group, each walking every chunks-th window. labels 16-byte aligned.
int stf_window_attention_head_group(const void* qkv, const void* bias,
                                    const void* labels, void* out,
                                    int32_t B, int32_t H, int32_t W,
                                    int32_t ws, int32_t C, int32_t nh,
                                    float scale, int32_t bf16,
                                    int32_t chunks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int hd = C / nh;
  if (ws != 8 || nh % WINATTN_HG_GROUP || chunks < 1 ||
      (int64_t)8 * W * 3 * C >= ((int64_t)1 << 31) ||
      (uintptr_t)qkv % 16 || (uintptr_t)out % 16 ||
      (uintptr_t)labels % 16 ||
      (uintptr_t)bias % 16)
    return (int)cudaErrorInvalidValue;
  const int32_t* lb = (const int32_t*)labels;
#define STF_HG(HD_)                                                          \
  if (hd == HD_) {                                                           \
    if (bf16)                                                                \
      return launch_head_group<__nv_bfloat16, HD_>(                          \
          (const __nv_bfloat16*)qkv, (const __nv_bfloat16*)bias, lb,         \
          (__nv_bfloat16*)out, B, H, W, C, nh, chunks, scale, st);           \
    return launch_head_group<float, HD_>((const float*)qkv,                  \
                                         (const float*)bias, lb,             \
                                         (float*)out, B, H, W, C, nh,        \
                                         chunks, scale, st);                 \
  }
  STF_HEAD_GROUP_WIDTHS(STF_HG)
#undef STF_HG
  return (int)cudaErrorInvalidValue;
}

const char* stf_window_attention_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
