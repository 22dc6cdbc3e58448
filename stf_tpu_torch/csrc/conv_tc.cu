// conv_tc: the f32 stride-1 convolution of the coding path, as an implicit
// GEMM on the tensor cores in 3xTF32.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// On the H100 the port's f32 convolutions went to cuDNN, which under the
// codec's numerical policy (deterministic algorithms, TF32 off, for
// lockstep: `utils/numerics.py`) picks f32 implicit GEMMs on the FMA pipes
// and FFT convolutions, 20-25 TFLOP/s, 70-84% of the device time of a
// compress or decompress (PERF.md section 5). This kernel computes
//   y[b, n, h, w] = bias[n] + sum_{c, i, j} w[n, c, i, j] *
//                   x[b, c, h + i - k/2, w + j - k/2]
// (zero outside the map) for f32 NCHW x and y, k in {1, 3, 5}, any batch,
// map and channel counts.
//
// GEMM. M = B*H*W output pixels, N = C_out, K = k*k*Cp with the channels
// padded to Cp, the next multiple of 8, in tap-major order: column
// (tap, c) of the weights is w[n, c, tap] (zero for c >= C_in), packed
// by `conv_tc_pack_kernel` into an (N, K) matrix of (big, small) pairs
// (3xTF32 below), so that every k8 step lies inside one tap. The A operand is the im2col of x, gathered while it
// is copied: element (m, (tap, c)) is channel c of x at pixel m shifted by
// the tap, or a zero-fill where the tap leaves the map.
//
// What bounds it on an H100: operations. A slice stack's 3x3 convolution
// at 32x48 (K = 9 C_in, N up to 224) does about 2 K flops a byte of x; at
// 165 TFLOP/s (the tensor cores' 495 TF32 over three products) the card
// meets its 3.35 TB/s at 49 flops a byte. Only the 3-channel output of
// STF's end_conv is bytes-bound.
//
// 3xTF32. Each f32 operand is split into a TF32 "big" part (x rounded to
// 10 mantissa bits) and its exact f32 remainder, which the tensor core
// reads as TF32 by dropping its low 13 bits; big*big' + big*small' +
// small*big' summed in f32 keeps about 21 bits of each product, against
// 10 for a single TF32 pass (which `correct` refuses). The same split as
// kernel B1's f32 path (`window_attention.cu`, split_tf32_rest).
//
// Rounding. The tensor core adds a tile's products to its accumulator
// with truncation, not round-to-nearest: chained through all of K (three
// mma a k8 step, 1,620 at K = 4,320) the bias reached 11x cuDNN's f32
// error against an f64 convolution on an H100. So each BK stage sums its
// 12 products a tile into a fresh accumulator (`part`, started by the
// stage's first mma from zero), which an f32 add rounds into the running
// sum: the truncations then act on a stage's partial sum, whose sign
// varies from stage to stage (1.6-2.9e-6 against cuDNN's 4-15e-6).
//
// Design (mma.sync m16n8k8 TF32):
//   * a block computes a BM x BN tile of y; its warps own WM x WN
//     sub-tiles (MT x NT m16n8 tiles); K runs through BK = 32 columns a
//     stage;
//   * a STAGES-deep cp.async ring in shared memory: A as As[k][m] (a k row
//     of BM pixels, pitch BM + 8 floats: the fragment reads (t, g) land on
//     32 distinct banks), B as its packed big and small parts (pitch
//     2 BK + 8: each half-warp's 8-byte reads on 32 distinct banks). A
//     thread copies one pixel's column of A: per k8 group of a stage one
//     tap, so one bounds test, and channels HW floats apart (4-byte
//     copies, zero-filled outside the map; 16-byte runs of 4 pixels for
//     k = 1 where H*W is a multiple of 4: an H100 ran a build with all
//     copies 16 bytes wide, wrong but otherwise alike, ~20% faster); B
//     moves in 16-byte runs;
//   * B's fragments arrive split (the packing splits the weights once a
//     call); A's are split in registers as they are read, once a (k8
//     step, m16 tile): the split, the accumulator adds and the loader's
//     address arithmetic, not the tensor pipe, bound the kernel (an H100
//     ran it as fast with the mma replaced by integer operations);
//   * the bias is added in the epilogue, which stores from the
//     accumulators: a lane quad's 8 rows of one channel are 32 contiguous
//     bytes of y.
// Blocks walk N tiles fastest, so the blocks that share an A tile run
// together and read it from L2.
//
// Split K. Where K is long a cluster of S blocks (S from C_in and k alone,
// `conv_core.splits`) shares one output tile: block r of the cluster runs
// the r-th of S equal runs of stages, and the S partial sums meet through
// distributed shared memory, summed in rank order by the cluster's blocks
// (each a share of the tile). A one-image map (M = 1,536 at 32x48) then
// still fills the card.
//
// Transposed convolution (`conv_tc_deconv_kernel`). The synthesis
// transforms' 5x5 stride-2 upsamplers (padding 2, output padding 1: exact
// 2x) also replace no TPU kernel: the JAX package leaves them to XLA's
// conv_transpose, and the port left them to cuDNN's backward-data kernels
// (dgrad2d, ~16 TFLOP/s at batch 24 and ~5 at batch 1 on an H100). By
// sub-pixel decomposition, output row 2m + p takes the even taps {0, 2, 4}
// of the kernel on input rows m + 1, m, m - 1 (p = 0) or the odd taps
// {1, 3} on rows m + 1, m (p = 1), and columns alike. So each output
// phase (py, px) is a stride-1 correlation of x with a (3 - py) x (3 - px)
// sub-kernel: the taps (i, j) of a 3x3 window (padding 1) with i >= py and
// j >= px. The four phases use the 25 taps once each. In the PHASES form a
// block computes one phase's tile of a GEMM with M = B*H*W input pixels,
// N = C_out and K = its 9, 6, 6 or 4 taps x Cp, so no zero tap is
// multiplied; the packing (`conv_core.deconv_pack_weight`) holds the four
// phases' B operands one after another. The epilogue stores each output
// to (2h + py, 2w + px) with its bias: no pixel shuffle, no intermediate.
// Bound: operations (165 TFLOP/s) at the synthesis's widths. Where C_out
// is small (192 -> 3: ~38 flops a byte of x, under the card's 49) bytes
// bound it, and in practice the loader's gathers: the JOINT form puts the
// four phases in one N tile (N = 4 C_out, column 4 co + 2 py + px, over
// the whole 3x3 window, the absent taps' weights zero), so x is gathered
// once, not once a phase.
// `conv_core.deconv_joint` picks the form from C_out alone. Split K, the
// stage order and the fresh accumulator a stage are the convolution's:
// every output sums in an order fixed by C_in and its phase's taps.
//
// Lockstep. No atomics, and no order that depends on M: every output is
// the rank-order sum of its S partial sums, each a run of k8 steps in
// order (the three products of a step small terms first, a stage's
// summed apart and added to the running sum), whatever the
// tile configuration or the batch, so an image's outputs are bitwise the
// same at any batch, under any configuration, and under CUDA-graph
// replay. The wrapper picks the configuration from (M, N, S) by a fixed
// table (`layers/conv_core.py`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 32;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// x = big + small: big is x rounded to TF32 (its low 13 bits cleared,
// ties away from zero, as cvt.rna), small the exact rest, which the tensor
// core reads as TF32 by ignoring its low 13 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// x = big + small for an A operand, one instruction fewer: big is x as
// it stands (the tensor core reads it truncated to TF32), small the rest
// after that truncation, about one bit less of each product than
// split_tf32's (1.6-2.9e-6 of an f64 convolution against cuDNN's 4-15e-6
// with it; about 4% faster on an H100).
__device__ __forceinline__ void split_tf32_trunc(float x, uint32_t& big,
                                                 uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// What a block computes: a convolution's tile, one phase's tile of a
// transposed convolution, or a tile of all four phases at once (see
// "Transposed convolution" above).
enum Mode : int { CONV = 0, PHASES = 1, JOINT = 2 };

// Rounds f32 bits to TF32 (ties away from zero, as cvt.rna).
__device__ __forceinline__ uint32_t round_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// The A operand's split: truncated for the convolution; in the transposed
// modes big and small both rounded to TF32, so that the tensor core reads
// the small part exactly (see "Transposed convolution").
template <int MODE>
__device__ __forceinline__ void split_a(float x, uint32_t& big,
                                        uint32_t& small) {
  if (MODE == CONV) {
    split_tf32_trunc(x, big, small);
  } else {
    big = round_tf32(__float_as_uint(x));
    small = round_tf32(__float_as_uint(x - __uint_as_float(big)));
  }
}

// d += a . b on one m16n8k8 TF32 tile, f32 accumulation. Not volatile:
// the compiler may interleave independent tiles' chains.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b on one m16n8k8 TF32 tile (the accumulator starts at zero).
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// A tile configuration: BM x BN outputs a block, WM x WN a warp, STAGES
// buffers in the ring, at least MINB blocks an SM (__launch_bounds__).
template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_, MINB = MINB_;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int ACC = MT * NT * 4;  // accumulators a thread
  static constexpr int LDA = BM + 8;  // As[k][m]
  static constexpr int LDB = 2 * BK + 8;  // Bs[n][k][big, small]
  static constexpr int A_FLOATS = BK * LDA, B_FLOATS = BN * LDB;
  static constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
  static constexpr int SMEM = STAGES * STAGE_FLOATS * (int)sizeof(float);
  // A copies: a thread's pixel (run of 4 pixels) and its k rows, STEP
  // (VSTEP) apart
  static constexpr int STEP = THREADS / BM, VSTEP = THREADS / (BM / 4);
  static_assert(BM % WM == 0 && BN % WN == 0, "warp tiles");
  static_assert(WM % 16 == 0 && WN % 8 == 0, "m16n8 tiles");
  static_assert(BM % 32 == 0, "A pitch: 32 distinct banks");
  static_assert(THREADS % BM == 0 && 8 % STEP == 0,
                "whole pixel columns, k8 groups split evenly");
  static_assert(THREADS % (BM / 4) == 0 && BK % VSTEP == 0,
                "whole 4-pixel runs a pass");
  static_assert(THREADS * ACC <= STAGES * STAGE_FLOATS,
                "the split-K partial sums fit the ring");
};

// Index, tile shape, warp tile, stages, minimum blocks an SM. The wrapper's
// table (`conv_core.CONFIGS`) mirrors it.
#define CONV_TC_CONFIGS(X)      \
  X(0, 128, 64, 32, 32, 3, 2)   \
  X(1, 64, 64, 32, 32, 4, 2)    \
  X(2, 64, 32, 32, 32, 4, 3)    \
  X(3, 128, 16, 32, 16, 4, 2)   \
  X(4, 128, 8, 32, 8, 4, 2)

// The taps before phase p's in the PHASES packing: 0, 9, 15, 21.
__device__ __forceinline__ int phase_tap_offset(int p) {
  return p ? 6 * p + 3 : 0;
}

// One block's tile. KS is 3 in both transposed modes (the 3x3 window of
// padding 1 that holds every phase's taps); there `N` is C_out (PHASES)
// or 4 C_out (JOINT), and y is (B, C_out, 2H, 2W).
template <class T, int KS, int MODE>
__device__ __forceinline__ void conv_tc_tile(
    const float* __restrict__ x, const float* __restrict__ wp,
    const float* __restrict__ bias, float* __restrict__ y, int C, int Cp,
    int H, int W, int N, int M, int n_tiles, int splits, int vec_a) {
  constexpr int PAD = KS / 2, KK = KS * KS;
  constexpr int BM = T::BM, BN = T::BN, MT = T::MT, NT = T::NT;
  constexpr int LDA = T::LDA, LDB = T::LDB, THREADS = T::THREADS;
  static_assert(MODE == CONV || KS == 3, "transposed modes use the 3x3 window");
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const int tile = (int)(blockIdx.x / splits);
  const int rank = (int)(blockIdx.x % splits);  // in its cluster
  const int n0 = (tile % n_tiles) * BN;
  // PHASES: tiles run (M tile, phase, N tile), N tiles fastest
  const int phase = MODE == PHASES ? (tile / n_tiles) & 3 : 0;
  const int m0 = (MODE == PHASES ? tile / n_tiles >> 2 : tile / n_tiles) * BM;
  const int py = phase >> 1, px = phase & 1;
  const int HW = H * W;
  // PHASES: this phase's (3 - py) x (3 - px) taps and its packed operand
  const int K = (MODE == PHASES ? (3 - py) * (3 - px) : KK) * Cp;
  if (MODE == PHASES) wp += (size_t)N * 2 * Cp * phase_tap_offset(phase);
  const int KT = (K + BK - 1) / BK;
  const int per = (KT + splits - 1) / splits;
  const int kt_begin = min(KT, rank * per);
  const int kt_end = min(KT, kt_begin + per);

  // This thread's A column: one pixel (or a run of 4 with vec_a) and the
  // k rows it copies in each k8 group of a stage, from a_q on; `taps`
  // holds a bit for each tap that stays inside the map at that pixel.
  const bool vec = KS == 1 && vec_a;
  const int a_m = vec ? (tid % (BM / 4)) * 4 : tid % BM;
  const int a_q = vec ? tid / (BM / 4) : tid / BM;
  const int m_a = m0 + a_m;
  const bool m_ok = m_a < M;
  int xa = 0;  // x's offset of this thread's first element (x has < 2^31)
  uint32_t taps = 0;
  if (m_ok) {
    const int b = m_a / HW, p = m_a - b * HW;
    const int a_h = p / W, a_w = p - a_h * W;
    xa = b * C * HW + p + a_q * HW;
#pragma unroll
    for (int tap = 0; tap < KK; ++tap)
      if ((unsigned)(a_h + tap / KS - PAD) < (unsigned)H &&
          (unsigned)(a_w + tap % KS - PAD) < (unsigned)W)
        taps |= 1u << tap;
  }
  // (tap, channel) of the next stage's first column: the stages load in
  // order, so it advances by BK a load, without a division. PHASES keeps
  // the tap as its index in the 3x3 window: the phase's taps are those
  // with row >= py and column >= px, so the next after a row's last
  // (column 2) skips px columns.
  int ld_tap = kt_begin * BK / Cp, ld_c = kt_begin * BK - ld_tap * Cp;
  if (MODE == PHASES)
    ld_tap = (py + ld_tap / (3 - px)) * 3 + px + ld_tap % (3 - px);
  auto next_tap = [&](int& tap) {
    if (MODE == PHASES && tap % 3 == 2)
      tap += 1 + px;
    else
      ++tap;
  };

  auto load_stage = [&](int kt, int stage) {
    float* As = smem + stage * T::STAGE_FLOATS;
    float* Bs = As + T::A_FLOATS;
    const int k0 = kt * BK;
    if (vec) {  // k = 1: column k is channel k
#pragma unroll
      for (int i = 0; i < BK / T::VSTEP; ++i) {
        const int c = k0 + i * T::VSTEP;  // less a_q
        const bool ok = m_ok && c + a_q < C;
        cp_async16(As + (a_q + i * T::VSTEP) * LDA + a_m,
                   x + (ok ? xa + c * HW : 0), ok);
      }
    } else {
      int tap = ld_tap, c = ld_c;
#pragma unroll
      for (int grp = 0; grp < BK / 8; ++grp) {
        if (grp > 0) {
          c += 8;
          if (c >= Cp) {  // Cp >= 8: one tap at most
            c -= Cp;
            next_tap(tap);
          }
        }
        // taps past the last (tap >= KK, the padded tail) have no bit
        const bool ok = (taps >> tap) & 1u;
        const int src = xa + (tap / KS - PAD) * W + (tap % KS - PAD) + c * HW;
        float* dst = As + (grp * 8 + a_q) * LDA + a_m;
#pragma unroll
        for (int i = 0; i < 8 / T::STEP; ++i) {
          const bool v = ok && c + a_q + i * T::STEP < C;
          cp_async4(dst + i * T::STEP * LDA,
                    x + (v ? src + i * T::STEP * HW : 0), v);
        }
      }
      c += 8 + BK - BK / 8 * 8;
      if (c >= Cp) {
        c -= Cp;
        next_tap(tap);
      }
      ld_tap = tap;
      ld_c = c;
    }
    // B: each row's 32 columns as (big, small) pairs, 16 runs of 16 bytes
    constexpr int CHUNKS = BN * (2 * BK / 4);
#pragma unroll
    for (int i0 = 0; i0 < CHUNKS; i0 += THREADS) {
      const int i = i0 + tid;
      if (CHUNKS % THREADS == 0 || i < CHUNKS) {
        const int nr = i / (2 * BK / 4), kc = (i % (2 * BK / 4)) * 4;
        const int n = n0 + nr, k2 = 2 * k0 + kc;
        const bool ok = n < N && k2 < 2 * K;
        cp_async16(Bs + nr * LDB + kc, wp + (ok ? n * 2 * K + k2 : 0), ok);
      }
    }
  };

  // acc: the running sum; part: one stage's, started from zero by the
  // stage's first product (see "Rounding" above)
  float acc[MT][NT][4], part[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (kt_begin + s < kt_end) load_stage(kt_begin + s, s);
    cp_async_commit();
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free to refill
    const int next = kt + T::STAGES - 1;
    if (next < kt_end) load_stage(next, (next - kt_begin) % T::STAGES);
    cp_async_commit();

    const float* As = smem + ((kt - kt_begin) % T::STAGES) * T::STAGE_FLOATS;
    const float* Bs = As + T::A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // the k8 group's (big t, big t + 4) and (small t, small t + 4):
        // each an operand pair as the mma takes it
        const float* bp = Bs + (wn * T::WN + nt * 8 + g) * LDB + 2 * kk + 2 * t;
        const float2 big = *(const float2*)bp, small = *(const float2*)(bp + 8);
        bb[nt][0] = __float_as_uint(big.x);
        bb[nt][1] = __float_as_uint(big.y);
        bs[nt][0] = __float_as_uint(small.x);
        bs[nt][1] = __float_as_uint(small.y);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* ap = As + (kk + t) * LDA + wm * T::WM + mt * 16 + g;
        uint32_t ab[4], as[4];
        split_a<MODE>(ap[0], ab[0], as[0]);
        split_a<MODE>(ap[8], ab[1], as[1]);
        split_a<MODE>(ap[4 * LDA], ab[2], as[2]);
        split_a<MODE>(ap[4 * LDA + 8], ab[3], as[3]);
        // the NT tiles' chains interleaved
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (kk == 0)
            mma_tf32_zero(part[mt][nt], as, bb[nt][0], bb[nt][1]);
          else
            mma_tf32(part[mt][nt], as, bb[nt][0], bb[nt][1]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(part[mt][nt], ab, bs[nt][0], bs[nt][1]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(part[mt][nt], ab, bb[nt][0], bb[nt][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
  }
  cp_async_wait<0>();

  // accumulator e of this thread (e = (mt * NT + nt) * 4 + r) -> y
  auto store = [&](int e, float v) {
    const int mt = e / (NT * 4), nt = (e / 4) % NT, r = e % 4;
    const int m = m0 + wm * T::WM + mt * 16 + g + 8 * (r >> 1);
    const int n = n0 + wn * T::WN + nt * 8 + 2 * t + (r & 1);
    if (m < M && n < N) {
      const int b = m / HW, p = m - b * HW;
      if (MODE == CONV) {
        y[((size_t)b * N + n) * HW + p] =
            v + (bias != nullptr ? bias[n] : 0.0f);
      } else {
        // input pixel (h, w) of phase (oy, ox) -> output (2h + oy, 2w + ox)
        // of channel co: the JOINT form's column n is 4 co + 2 oy + ox
        const int h = p / W, w = p - h * W;
        const int co = MODE == JOINT ? n >> 2 : n;
        const int oy = MODE == JOINT ? (n >> 1) & 1 : py;
        const int ox = MODE == JOINT ? n & 1 : px;
        const int c_out = MODE == JOINT ? N >> 2 : N;
        y[((size_t)b * c_out + co) * 4 * HW + (size_t)(2 * h + oy) * 2 * W +
          2 * w + ox] = v + (bias != nullptr ? bias[co] : 0.0f);
      }
    }
  };

  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          store((mt * NT + nt) * 4 + r, acc[mt][nt][r]);
    return;
  }
  // Split K: each block's partial sums into its ring (element e of thread
  // tid at e * THREADS + tid); block `rank` sums the elements e = rank
  // (mod splits) of every block's, in rank order.
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // the ring's last stage is read
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        smem[((mt * NT + nt) * 4 + r) * THREADS + tid] = acc[mt][nt][r];
  cluster.sync();
  for (int e = rank; e < T::ACC; e += splits) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s)
      v += cluster.map_shared_rank(smem, s)[e * THREADS + tid];
    store(e, v);
  }
  cluster.sync();  // no block leaves while another reads its partial sums
}

template <class T, int KS>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
    conv_tc_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int C, int Cp, int H, int W, int N, int M, int n_tiles,
                   int splits, int vec_a) {
  conv_tc_tile<T, KS, CONV>(x, wp, bias, y, C, Cp, H, W, N, M, n_tiles,
                            splits, vec_a);
}

template <class T, int MODE>
__global__ void __launch_bounds__(T::THREADS, T::MINB)
    conv_tc_deconv_kernel(const float* __restrict__ x,
                          const float* __restrict__ wp,
                          const float* __restrict__ bias,
                          float* __restrict__ y, int C, int Cp, int H, int W,
                          int N, int M, int n_tiles, int splits) {
  conv_tc_tile<T, 3, MODE>(x, wp, bias, y, C, Cp, H, W, N, M, n_tiles,
                           splits, 0);
}

// Column k = tap * Cp + c of row n is split_tf32(w[n, c, tap]) (zero for
// C <= c < Cp); each group of 8 columns is stored as 16 floats, big parts
// then small parts, column j at 2 (j % 4) + j / 4 of its half: lane t of
// an mma reads its operand pair (columns t and t + 4) as one float2.
// With `round_small` the small part is rounded to TF32 too (the
// transposed modes' packing).
__global__ void conv_tc_pack_kernel(const float* __restrict__ w,
                                    float* __restrict__ wp, int C, int Cp,
                                    int KK, long long total,
                                    int round_small) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % Cp);
  const long long q = i / Cp;
  const int tap = (int)(q % KK);
  const long long n = q / KK;
  uint32_t big = 0, small = 0;
  if (c < C) split_tf32(w[(n * C + c) * KK + tap], big, small);
  if (round_small) small = round_tf32(small);
  const int j = (int)(i % 8);
  float* out = wp + (i - j) * 2 + 2 * (j % 4) + j / 4;
  out[0] = __uint_as_float(big);
  out[8] = __uint_as_float(small);
}

// Launches `kernel` on `blocks` blocks in clusters of `splits` along x.
template <class T, class Kernel, class... Args>
int launch_clusters(Kernel kernel, long long blocks, int splits,
                    cudaStream_t stream, Args... args) {
  if (T::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class T, int KS>
int launch(const float* x, const float* wp, const float* bias, float* y,
           int B, int C, int H, int W, int N, int splits,
           cudaStream_t stream) {
  const int M = B * H * W, Cp = (C + 7) / 8 * 8;
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const long long blocks =
      (long long)splits * n_tiles * ((M + T::BM - 1) / T::BM);
  const int vec_a = KS == 1 && (H * W) % 4 == 0 && (uintptr_t)x % 16 == 0;
  return launch_clusters<T>(conv_tc_kernel<T, KS>, blocks, splits, stream, x,
                            wp, bias, y, C, Cp, H, W, N, M, n_tiles, splits,
                            vec_a);
}

template <class T>
int launch_ks(const float* x, const float* wp, const float* bias, float* y,
              int B, int C, int H, int W, int N, int ks, int splits,
              cudaStream_t stream) {
  switch (ks) {
    case 1: return launch<T, 1>(x, wp, bias, y, B, C, H, W, N, splits, stream);
    case 3: return launch<T, 3>(x, wp, bias, y, B, C, H, W, N, splits, stream);
    case 5: return launch<T, 5>(x, wp, bias, y, B, C, H, W, N, splits, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// N is C_out; the JOINT form's GEMM has 4 C_out columns, the PHASES form
// four GEMMs of C_out.
template <class T>
int launch_deconv(const float* x, const float* wp, const float* bias,
                  float* y, int B, int C, int H, int W, int N, int joint,
                  int splits, cudaStream_t stream) {
  const int M = B * H * W, Cp = (C + 7) / 8 * 8;
  const int n_gemm = joint ? 4 * N : N;
  const int n_tiles = (n_gemm + T::BN - 1) / T::BN;
  const long long blocks = (long long)splits * n_tiles *
                           ((M + T::BM - 1) / T::BM) * (joint ? 1 : 4);
  auto kernel = joint ? conv_tc_deconv_kernel<T, JOINT>
                      : conv_tc_deconv_kernel<T, PHASES>;
  return launch_clusters<T>(kernel, blocks, splits, stream, x, wp, bias, y,
                            C, Cp, H, W, n_gemm, M, n_tiles, splits);
}

}  // namespace

extern "C" {

// The number of tile configurations (`CONV_TC_CONFIGS`).
int stf_conv_tc_configs() {
  int n = 0;
#define CONV_TC_COUNT(I, BM, BN, WM, WN, ST, MB) ++n;
  CONV_TC_CONFIGS(CONV_TC_COUNT)
#undef CONV_TC_COUNT
  return n;
}

// w: (N, C, taps) f32 (a kernel's taps in row-major order) -> wp: (N, taps
// * Cp, 2) f32, Cp = C rounded up to a multiple of 8 (the kernel's B
// operand, split; the small parts rounded to TF32 with `round_small`);
// contiguous. Launches on `stream`, returns cudaGetLastError().
int stf_conv_tc_pack(const void* w, void* wp, int32_t N, int32_t C,
                     int32_t taps, int32_t round_small, void* stream) {
  const int Cp = (C + 7) / 8 * 8, KK = taps;
  const long long total = (long long)N * KK * Cp;
  if (N < 1 || C < 1 || taps < 1 || total >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  conv_tc_pack_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                        0, (cudaStream_t)stream>>>(
      (const float*)w, (float*)wp, C, Cp, KK, total, round_small);
  return (int)cudaGetLastError();
}

// x: (B, C, H, W) f32; wp: `stf_conv_tc_pack`'s packing of the (N, C, ks,
// ks) weights; bias: (N,) f32 or null; y: (B, N, H, W) f32; x and wp
// 16-byte aligned, all contiguous. y = conv2d(x, w, padding ks / 2) + bias
// with tile configuration `config`, K split over `splits` blocks (1-8).
// Launches on `stream`, returns cudaGetLastError() (cudaErrorInvalidValue
// for an unsupported ks, configuration or split, a misaligned pointer, or
// x or the packed weights of 2^31 elements or more).
int stf_conv_tc(const void* x, const void* wp, const void* bias, void* y,
                int32_t B, int32_t C, int32_t H, int32_t W, int32_t N,
                int32_t ks, int32_t config, int32_t splits, void* stream) {
  if ((uintptr_t)x % 16 || (uintptr_t)wp % 16 || (uintptr_t)y % 4 ||
      (uintptr_t)bias % 4 || B < 1 || C < 1 || H < 1 || W < 1 || N < 1 ||
      splits < 1 || splits > 8 || (long long)B * H * W > 0x7fffff00LL ||
      (long long)B * C * H * W >= 0x7fffffffLL ||
      (long long)N * (C + 7) * ks * ks * 2 >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* wf = (const float*)wp;
  const float* bf = (const float*)bias;
  float* yf = (float*)y;
  cudaStream_t st = (cudaStream_t)stream;
#define CONV_TC_CASE(I, BM, BN, WM, WN, ST, MB)                          \
  if (config == I)                                                      \
    return launch_ks<Tile<BM, BN, WM, WN, ST, MB>>(xf, wf, bf, yf, B, C, \
                                                   H, W, N, ks, splits, st);
  CONV_TC_CONFIGS(CONV_TC_CASE)
#undef CONV_TC_CASE
  return (int)cudaErrorInvalidValue;
}

// x: (B, C, H, W) f32; wp: `conv_core.deconv_pack_weight`'s packing of the
// (C, N, 5, 5) weights, in the JOINT form if `joint`, else PHASES; bias:
// (N,) f32 or null; y: (B, N, 2H, 2W) f32; x and wp 16-byte aligned, all
// contiguous. y = conv_transpose2d(x, w, stride 2, padding 2, output
// padding 1) + bias with tile configuration `config`, K split over
// `splits` blocks (1-8). Launches on `stream`, returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported configuration or split, a
// misaligned pointer, or x or the packed weights of 2^31 elements or
// more).
int stf_conv_tc_deconv(const void* x, const void* wp, const void* bias,
                       void* y, int32_t B, int32_t C, int32_t H, int32_t W,
                       int32_t N, int32_t joint, int32_t config,
                       int32_t splits, void* stream) {
  if ((uintptr_t)x % 16 || (uintptr_t)wp % 16 || (uintptr_t)y % 4 ||
      (uintptr_t)bias % 4 || B < 1 || C < 1 || H < 1 || W < 1 || N < 1 ||
      splits < 1 || splits > 8 || (long long)B * H * W > 0x7fffff00LL ||
      (long long)B * C * H * W >= 0x7fffffffLL ||
      (long long)N * (C + 7) * 36 * 2 >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  const float* wf = (const float*)wp;
  const float* bf = (const float*)bias;
  float* yf = (float*)y;
  cudaStream_t st = (cudaStream_t)stream;
#define CONV_TC_DECONV_CASE(I, BM, BN, WM, WN, ST, MB)                     \
  if (config == I)                                                        \
    return launch_deconv<Tile<BM, BN, WM, WN, ST, MB>>(                   \
        xf, wf, bf, yf, B, C, H, W, N, joint, splits, st);
  CONV_TC_CONFIGS(CONV_TC_DECONV_CASE)
#undef CONV_TC_DECONV_CASE
  return (int)cudaErrorInvalidValue;
}

const char* stf_conv_tc_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
