// K1-f32 and K2-f32's one-pass form at H = 128 and 256 (F = 4H, BERT-Tiny
// and BERT-Mini in f32) on Hopper: the whole FFN sublayer of a row tile in
// one block, y = LN2(x + GELU(x . W1 + b1) . W2 + b2) with x = LN0(z) (K1)
// or z (K2), as the Pallas body does in VMEM
// (multimodal_rare_disease_tpu/ops/pallas/ffn.py:72-133). Built by
// ffn_rows_f32.cu; ffn_ln_f32.cu's C entries launch it.
//
// Why: at these widths the four-launch form (the operands' TF32 planes; h =
// GELU(x . W1 + b1) as two planes [M, F]; h . W2 into f32 partials; the
// LayerNorm pass) moves h's planes through device memory and back (268 MB
// at H = 256 and M = 16,384, a third of the call) and the partials once
// more, where the function needs only z in and y out, and its first GEMM
// walks only H / 32 k-tiles a tile, so each tile's ring fill and h store
// are paid with nothing to overlap them.
//
// What bounds it on the H100: the operations, 3 TF32 products of 4 M H F
// flops (a 128-row tile at 256 is 402.7 MFLOP: ~107 us at 495 TFLOP/s over
// 132 SMs). Measured (PERF.md): a chunk's products keep the tensor cores
// ~85% busy; stage 1's k8 step runs near their rate for its two m64n128k8
// products, a quarter of whose work (x_lo . W1_lo) the function does not
// need; the GELU (~2,400 clk a chunk of the SM's arithmetic) hides behind
// the other warpgroup's products (applied block by block inside stage 2 it
// gained nothing).
//
// Design: one block per tile of 128 rows (at the packed 16,384 rows 128
// blocks on the 132 SMs, one wave), with gemm_tf32x3's producer thread and
// two consumer warpgroups of 64 rows. z comes in once by TMA as H / 32
// boxes of [128 rows][32] in the 128-byte swizzle; for K1 each consumer warp
// applies LN0 in place to its 16 rows with load_row_f32's arithmetic, so x
// has the bits that split_operands splits. Then, per chunk of 64 columns of
// F:
//   stage 1: h = GELU(x . W1 + b1) for the chunk, A = the thread's wgmma
//     fragment of x loaded from shared memory and split into its TF32 planes
//     in registers, B = W1^T's planes from the ring, laid out as one
//     [128][32] tile of 64 hi rows over 64 lo rows, so a k8 step is two
//     m64n128k8 products, x_hi . [B_hi | B_lo] and x_lo . [B_hi | B_lo],
//     whose halves sum x . W1_hi and x . W1_lo over K = H: the four-launch
//     form's big and small, with x_lo . W1_hi in the big half and x_lo .
//     W1_lo added (an m64n64k8 for x_lo . W1_hi alone cost nearly as much as
//     the m64n128k8, PERF.md). x has the four-launch form's bits; h is
//     within a few f32 ulps of its planes. b1 and the exact-erf GELU as
//     gemm_tf32x3<kGelu>'s epilogue; the chunk stays in the registers of its
//     stage-1 accumulator.
//   stage 2: A = h's TF32 planes made from those registers, B = W2^T's
//     planes. A thread holds h's columns 2 (lane % 4) and + 1 of each 8,
//     where a TF32 A fragment holds columns lane % 4 and + 4: the weight
//     split writes W2^T's planes with F permuted within each group of 8
//     (position p holds column 2p for p < 4 and 2 (p - 4) + 1 after), so
//     the accumulator's order is the k order. That changes the order of the
//     sums inside a k8 step against the four-launch form, not the products.
// Stage 2's sums: at H = 128 the four-launch form's, big (h_hi . W_hi) and
// small (h_hi . W_lo + h_lo . W_hi) over windows of K = 256 (4 chunks), each
// window added to a total (rounded to nearest) kept in shared memory until
// the last; at H = 256 the [64 x 256] output of a warpgroup is 128 registers
// a thread, so its three products go into one accumulator over the whole of
// F (two m64n128k8 halves): big, small and a total would be 384.
// Epilogue: b2 and x from the x buffer are added, LN2's row sums are quad
// shuffles (a thread's rows are whole in the four threads of a quad), y is
// written over x and stored by TMA. No partials, no second pass, no
// atomics: the same bits on every launch. Rows past M read as zeros (TMA)
// and are not stored.
//
// wgmma with A from registers: two register sets alternate, one group per
// k8 step, each retired (wgmma_wait<1>) before its set is written again, and
// a register fence after each retire (attn_out_rows_f32.cuh's consume_rs).
// Registers: 240 a consumer thread (the output's 128 accumulators, stage
// 1's 64, the fragments' 16), 24 the producer.
// Shared memory: a ring of 3 slots of 32 KB (a W1^T item: a chunk's 64 rows
// over 64 of H, both planes; or a W2^T item: 128 output columns over 32 of
// the chunk, both planes), x / y as H / 32 boxes of 16 KB, at H = 128 the
// window total (64 KB), and 7 barriers: 96 + 128 KB at 256, 96 + 64 + 64 KB
// at 128 (229,376 bytes, and 1,080 for the barriers and the alignment).

#pragma once

#include <cuda.h>

#include "gemm_tf32x3.cuh"

namespace {

using mrd::fence_regs;

// The one-pass form at hidden width kH
template <int kH>
struct FfnRowsF32 {
  static constexpr int kN = kH / kBN;                   // 128-column halves of y: 1, 2
  static constexpr bool kWindowed = kH == 128;          // stage 2 keeps windows
  static constexpr int kChunk = 64;                     // F columns a chunk
  static constexpr int kW1Items = kH / 64;              // W1^T items a chunk: 64 of H each
  static constexpr int kWindowChunks = kWindow * kBK / kChunk;  // 4 chunks: K = 256
  static constexpr uint32_t kSlot = 2 * kTileBytes;     // 32 KB
  static constexpr int kSlots = 3;
  static constexpr int kRegs = 240;
  static constexpr int kProducerRegs = 24;
  // the ring, x / y, the window total (kWindowed), the barriers: the slots'
  // full (TMA bytes) and empty (every consumer warp), and x's (TMA bytes)
  static constexpr uint32_t kOffX = kSlots * kSlot;
  static constexpr uint32_t kOffTotal = kOffX + (kH / kBK) * kTileBytes;
  static constexpr uint32_t kBarFull = kOffTotal + (kWindowed ? kBM * kH * 4 : 0);
  static constexpr uint32_t kBarEmpty = kBarFull + 8 * kSlots;
  static constexpr uint32_t kBarX = kBarEmpty + 8 * kSlots;
  static constexpr uint32_t kSmemBytes = kBarX + 8 + 1024;
  static_assert(kH == 128 || kH == 256, "the widths whose tile's output fits the registers");
  static_assert(kSlot % 1024 == 0 && kOffX % 1024 == 0, "1024-byte swizzle atoms");
  static_assert(2 * 128 * kRegs + 128 * kProducerRegs == kThreads * 168,
                "setmaxnreg must hand over exactly the registers it frees");
  static_assert(kSmemBytes <= 232448, "over the per-block shared memory");
};

// Weights for the pass: W1^T [F, kH] into its planes as it is, W2^T [kH, F]
// into its planes with F permuted within each group of 8 (position p of a
// group holds column 2p for p < 4, 2 (p - 4) + 1 after). Threads [0, F kH
// / 4) take a float4 of W1^T each, the next F kH / 8 a group of W2^T.
__global__ void __launch_bounds__(kSplitThreads)
split_weights_rows(const float* __restrict__ w1t, const float* __restrict__ w2t,
                   float* __restrict__ w1_hi, float* __restrict__ w1_lo,
                   float* __restrict__ w2_hi, float* __restrict__ w2_lo, long long fh) {
  long long q = static_cast<long long>(blockIdx.x) * kSplitThreads + threadIdx.x;
  float4 hi, lo;
  if (q < fh / 4) {
    split4(reinterpret_cast<const float4*>(w1t)[q], hi, lo);
    reinterpret_cast<float4*>(w1_hi)[q] = hi;
    reinterpret_cast<float4*>(w1_lo)[q] = lo;
    return;
  }
  q -= fh / 4;
  if (q >= fh / 8) return;
  const float4 a = reinterpret_cast<const float4*>(w2t)[2 * q];
  const float4 b = reinterpret_cast<const float4*>(w2t)[2 * q + 1];
  split4(make_float4(a.x, a.z, b.x, b.z), hi, lo);
  reinterpret_cast<float4*>(w2_hi)[2 * q] = hi;
  reinterpret_cast<float4*>(w2_lo)[2 * q] = lo;
  split4(make_float4(a.y, a.w, b.y, b.w), hi, lo);
  reinterpret_cast<float4*>(w2_hi)[2 * q + 1] = hi;
  reinterpret_cast<float4*>(w2_lo)[2 * q + 1] = lo;
}

// The producer thread: z's tile into the x buffer, then for each chunk c
// its W1^T items (for each 64 of H: rows 64 c .. of the hi plane over those
// of the lo plane, two [128][32] blocks) and its W2^T items (for each 32 of
// the chunk and each 128 output columns: the hi plane, then the lo plane)
template <int kH>
__device__ __forceinline__ void produce_ffn_rows(const CUtensorMap* z, const CUtensorMap* w1h,
                                                 const CUtensorMap* w1l, const CUtensorMap* w2h,
                                                 const CUtensorMap* w2l, uint32_t base, int row0,
                                                 int chunks) {
  using R = FfnRowsF32<kH>;
  mbar_arrive_expect_tx(base + R::kBarX, (kH / kBK) * kTileBytes);
#pragma unroll
  for (int b = 0; b < kH / kBK; ++b)
    tma_load_2d(base + R::kOffX + b * kTileBytes, z, base + R::kBarX, b * kBK, row0);
  Ring ring;
  for (int c = 0; c < chunks; ++c) {
    for (int i = 0; i < R::kW1Items; ++i) {
      mbar_wait(base + R::kBarEmpty + 8 * ring.slot, ring.phase ^ 1);
      const uint32_t full = base + R::kBarFull + 8 * ring.slot;
      const uint32_t dst = base + ring.slot * R::kSlot;
      mbar_arrive_expect_tx(full, R::kSlot);
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        tma_load_2d(dst + kb * kTileBytes, w1h, full, 64 * i + kBK * kb, R::kChunk * c);
        tma_load_2d(dst + kb * kTileBytes + kTileBytes / 2, w1l, full, 64 * i + kBK * kb,
                    R::kChunk * c);
      }
      ring.next<R::kSlots>();
    }
    for (int i = 0; i < 2 * R::kN; ++i) {
      mbar_wait(base + R::kBarEmpty + 8 * ring.slot, ring.phase ^ 1);
      const uint32_t full = base + R::kBarFull + 8 * ring.slot;
      const uint32_t dst = base + ring.slot * R::kSlot;
      mbar_arrive_expect_tx(full, R::kSlot);
      const int k = R::kChunk * c + kBK * (i / R::kN), n = kBN * (i % R::kN);
      tma_load_2d(dst, w2h, full, k, n);
      tma_load_2d(dst + kTileBytes, w2l, full, k, n);
      ring.next<R::kSlots>();
    }
  }
}

// LN0 in place on rows row0 .. row0 + 15 of the x buffer (one warp), four
// rows at a time: load_row_f32's arithmetic on the same float4s per lane
// (columns 4 (lane + 32 j) ..), so x has the bits split_operands splits
template <int kH>
__device__ __forceinline__ void ln0_rows(uint32_t x, int row0, int lane,
                                         const float* __restrict__ g0,
                                         const float* __restrict__ o0, float eps) {
  constexpr int kV = kF32RowVecs<kH>;
  constexpr int kR = 4;
  float4 g[kV], o[kV];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    g[j] = *reinterpret_cast<const float4*>(g0 + 4 * (lane + 32 * j));
    o[j] = *reinterpret_cast<const float4*>(o0 + 4 * (lane + 32 * j));
  }
  for (int i0 = 0; i0 < 16; i0 += kR) {
    uint32_t at[kR][kV];
    float4 out[kR][kV];
    float mu[kR], rstd[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int r = row0 + i0 + rr;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const int q = lane + 32 * j;  // the row's float4 q: box q / 8, 16-byte group q % 8
        at[rr][j] = x + (q / 8) * kTileBytes + r * 128 + (((q % 8) ^ (r % 8)) << 4);
        out[rr][j] = ld_shared_f4(at[rr][j]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kV; ++j)
        s += (out[rr][j].x + out[rr][j].y) + (out[rr][j].z + out[rr][j].w);
      mu[rr] = mrd::warp_sum(s) * (1.0f / kH);
    }
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      float q = 0.0f;
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float4& v = out[rr][j];
        const float4 d = make_float4(v.x - mu[rr], v.y - mu[rr], v.z - mu[rr], v.w - mu[rr]);
        q += (d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w);
      }
      rstd[rr] = rsqrtf(mrd::warp_sum(q) * (1.0f / kH) + eps);
    }
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float4& v = out[rr][j];
        const float m = mu[rr], rs = rstd[rr];
        st_shared_f4(at[rr][j],
                     make_float4((v.x - m) * rs * g[j].x + o[j].x, (v.y - m) * rs * g[j].y + o[j].y,
                                 (v.z - m) * rs * g[j].z + o[j].z, (v.w - m) * rs * g[j].w + o[j].w));
      }
    }
  }
}

// A consumer's place in the ring: the slot it reads, and the slot whose
// last group is still in flight (`held`), released once that retires
struct Feed {
  Ring ring;
  uint32_t prev = 0;
  bool held = false;
};

// Waits for the slot of an item's first k8 step
template <int kH>
__device__ __forceinline__ uint32_t item_start(Feed& feed, uint32_t base) {
  using R = FfnRowsF32<kH>;
  mbar_wait(base + R::kBarFull + 8 * feed.ring.slot, feed.ring.phase);
  return opaque(base) + feed.ring.slot * R::kSlot;
}

// After a group is issued: retire the one before (its register set is `f`);
// at an item's first step that frees the previous item's slot
template <int kH>
__device__ __forceinline__ void retire(Feed& feed, uint32_t (&f)[8], uint32_t base, bool first,
                                       bool signal) {
  using R = FfnRowsF32<kH>;
  mrd::wgmma_wait<1>();
  fence_regs(f);
  if (first) {
    if (feed.held && signal) mbar_arrive(base + R::kBarEmpty + 8 * feed.prev);
    feed.prev = feed.ring.slot;
    feed.held = true;
    feed.ring.next<R::kSlots>();
  }
}

// Every group retired: the last item's slot is free
template <int kH>
__device__ __forceinline__ void drain(Feed& feed, uint32_t (&a)[2][8], uint32_t base,
                                      bool signal) {
  using R = FfnRowsF32<kH>;
  mrd::wgmma_wait<0>();
  fence_regs(a[0]);
  fence_regs(a[1]);
  if (feed.held && signal) mbar_arrive(base + R::kBarEmpty + 8 * feed.prev);
  feed.held = false;
}

// The TF32 planes of four f32 values into a fragment: hi = tf32(v), lo = v
// - hi (split4's)
__device__ __forceinline__ void split_frag(uint32_t (&f)[8], float v0, float v1, float v2,
                                           float v3) {
  const float v[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float hi = tf32_rna(v[i]);
    f[i] = __float_as_uint(hi);
    f[4 + i] = __float_as_uint(v[i] - hi);
  }
}

// Grid: one block per 128 rows. Consumer wg holds rows 64 wg .. + 64 of
// the tile, all kH output columns.
template <int kH, bool kInputLN>
__global__ void __launch_bounds__(kThreads, 1)
ffn_rows_f32(const __grid_constant__ CUtensorMap z_map,    // z [M, H], [128][32] boxes
             const __grid_constant__ CUtensorMap w1h_map,  // W1^T's planes [F, H], [64][32]
             const __grid_constant__ CUtensorMap w1l_map,
             const __grid_constant__ CUtensorMap w2h_map,  // W2^T's planes [H, F] (F
             const __grid_constant__ CUtensorMap w2l_map,  // permuted), [128][32]
             const __grid_constant__ CUtensorMap y_map,    // y [M, H], [64][32] boxes
             const float* __restrict__ b1, const float* __restrict__ b2,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const float* __restrict__ g0, const float* __restrict__ o0, int M, int F,
             float eps) {
  using R = FfnRowsF32<kH>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int row0 = blockIdx.x * kBM;
  const int chunks = F / R::kChunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kSlots; ++s) {
      mbar_init(base + R::kBarFull + 8 * s, 1);
      mbar_init(base + R::kBarEmpty + 8 * s, kWG * 4);  // every consumer warp
    }
    mbar_init(base + R::kBarX, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x / 128 == kWG) {
    // ---- the producer warpgroup: one thread issues every TMA load
    mrd::setmaxnreg_dec<R::kProducerRegs>();
    if (threadIdx.x == 128 * kWG)
      produce_ffn_rows<kH>(&z_map, &w1h_map, &w1l_map, &w2h_map, &w2l_map, base, row0, chunks);
    return;
  }
  mrd::setmaxnreg_inc<R::kRegs>();
  const int wg = threadIdx.x / 128;
  const bool signal = lane == 0;  // one arrival per warp
  const int q = lane % 4;
  // the thread's rows r and r + 8 of the tile; its warp's 16 rows from r16
  const int r16 = 64 * wg + 16 * (warp % 4);
  const int r = r16 + lane / 4;
  mbar_wait(base + R::kBarX, 0);
  if constexpr (kInputLN) {
    ln0_rows<kH>(base + R::kOffX, r16, lane, g0, o0, eps);
    __syncwarp();
  }
  // x's row r in the buffer, at the thread's k column q of a k8 step
  const uint32_t xrow = base + R::kOffX + r * 128 + 4 * q;

  float acc[2][64];  // 256: y's two 128-column halves; 128: big and small
  float s1[64];      // stage 1: the chunk's products with W1_hi (0-63) and W1_lo (64-127)
  uint32_t a[2][8];  // the A planes of two k8 steps
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.0f;
  Feed feed;
  for (int c = 0; c < chunks; ++c) {
    // ---- stage 1: s1 = x_hi . [W1_hi | W1_lo] + x_lo . [W1_hi | W1_lo]
#pragma unroll
    for (int i = 0; i < R::kW1Items; ++i) {
      const uint32_t st = item_start<kH>(feed, base);
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = 8 * i + 4 * kb + kk;  // k8 step over H
          uint32_t(&f)[8] = a[kk % 2];
          const uint32_t box = xrow + (j / 4) * kTileBytes;
          const uint32_t c0 = box + (((2 * kk) ^ (lane / 4)) << 4);
          const uint32_t c1 = box + (((2 * kk + 1) ^ (lane / 4)) << 4);
          split_frag(f, mrd::ld_shared_f32(c0), mrd::ld_shared_f32(c0 + 8 * 128),
                     mrd::ld_shared_f32(c1), mrd::ld_shared_f32(c1 + 8 * 128));
          const uint32_t(&hi)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&f[0]);
          const uint32_t(&lo)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&f[4]);
          fence_regs(f);
          mrd::fence_operand(s1);
          mrd::wgmma_fence();
          const uint64_t d = sw128_desc(st + kb * kTileBytes + kk * 32);
          if (j == 0)
            mrd::wgmma_m64n128k8_tf32_rs_first(s1, hi, d);
          else
            mrd::wgmma_m64n128k8_tf32_rs(s1, hi, d, 1);
          mrd::wgmma_m64n128k8_tf32_rs(s1, lo, d, 1);
          mrd::wgmma_commit();
          mrd::fence_operand(s1);
          retire<kH>(feed, a[(kk + 1) % 2], base, kb == 0 && kk == 0, signal);
        }
      }
    }
    drain<kH>(feed, a, base, signal);
    mrd::fence_operand(s1);
    // h = GELU(the two halves + b1): gemm_tf32x3<kGelu>'s epilogue, into s1[0, 32)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 b = *reinterpret_cast<const float2*>(b1 + R::kChunk * c + 8 * nb + 2 * q);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * nb + 2 * half;
        const float v0 = (s1[i] + s1[32 + i]) + b.x;
        const float v1 = (s1[i + 1] + s1[32 + i + 1]) + b.y;
        s1[i] = 0.5f * v0 * (1.0f + erff(v0 * 0.70710678118654752f));
        s1[i + 1] = 0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f));
      }
    }
    // ---- stage 2: h's planes from s1 (k8 step s: h columns 8 s + 2 q and +
    // 1 of rows r and r + 8, the k positions q and q + 4 of the permuted
    // W2^T) times W2^T's planes
#pragma unroll
    for (int i = 0; i < 2 * R::kN; ++i) {
      const int n = i % R::kN;  // y's columns 128 n ..
      const uint32_t st = item_start<kH>(feed, base);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int s = 4 * (i / R::kN) + kk;  // k8 step of the chunk
        uint32_t(&f)[8] = a[kk % 2];
        split_frag(f, s1[4 * s], s1[4 * s + 2], s1[4 * s + 1], s1[4 * s + 3]);
        const uint32_t(&hi)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&f[0]);
        const uint32_t(&lo)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&f[4]);
        fence_regs(f);
        mrd::fence_operand(acc[0]);
        mrd::fence_operand(acc[1]);
        mrd::wgmma_fence();
        const uint64_t dh = sw128_desc(st + kk * 32), dl = sw128_desc(st + kTileBytes + kk * 32);
        // the first step of the sum (R::kWindowed: of a window) overwrites
        const bool restart = i < R::kN && kk == 0 &&
                             (R::kWindowed ? c % R::kWindowChunks == 0 : c == 0);
        if constexpr (R::kWindowed) {
          mrd::wgmma_m64n128k8_tf32_rs(acc[0], hi, dh, restart ? 0 : 1);
          mrd::wgmma_m64n128k8_tf32_rs(acc[1], hi, dl, restart ? 0 : 1);
          mrd::wgmma_m64n128k8_tf32_rs(acc[1], lo, dh, 1);
        } else {
          mrd::wgmma_m64n128k8_tf32_rs(acc[n], hi, dh, restart ? 0 : 1);
          mrd::wgmma_m64n128k8_tf32_rs(acc[n], hi, dl, 1);
          mrd::wgmma_m64n128k8_tf32_rs(acc[n], lo, dh, 1);
        }
        mrd::wgmma_commit();
        mrd::fence_operand(acc[0]);
        mrd::fence_operand(acc[1]);
        retire<kH>(feed, a[(kk + 1) % 2], base, kk == 0, signal);
      }
    }
    if constexpr (R::kWindowed) {
      // a window's end before the last: its big + small into the total,
      // thread-major (float i of consumer thread t at 4 (256 i + t))
      if (c % R::kWindowChunks == R::kWindowChunks - 1 && c + 1 < chunks) {
        drain<kH>(feed, a, base, signal);
        mrd::fence_operand(acc[0]);
        mrd::fence_operand(acc[1]);
        const uint32_t tot = base + R::kOffTotal + 4 * threadIdx.x;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float v = acc[0][i] + acc[1][i];
          mrd::sts_f32(tot + 1024 * i,
                       c < R::kWindowChunks ? v : mrd::ld_shared_f32(tot + 1024 * i) + v);
        }
      }
    }
  }
  drain<kH>(feed, a, base, signal);
  mrd::fence_operand(acc[0]);
  mrd::fence_operand(acc[1]);
  if constexpr (R::kWindowed) {
    // the total of the windows: acc[0] = total + (big + small)
    const uint32_t tot = base + R::kOffTotal + 4 * threadIdx.x;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float v = acc[0][i] + acc[1][i];
      acc[0][i] = chunks > R::kWindowChunks ? mrd::ld_shared_f32(tot + 1024 * i) + v : v;
    }
  }

  // ---- epilogue. Per 128-column half n (y's columns 128 n ..; one at 128,
  // where acc[0] holds the total) and n8 block nb the thread holds columns
  // 8 nb + 2 q and + 1 of rows r and r + 8: acc[n][4 nb + 2 half + e]. In x's
  // buffer column c lies in box c / 32, 16-byte group (c % 32) / 4 of its
  // 128-byte row, which the swizzle moves to that group ^ (row % 8) = lane /
  // 4. y goes over x at the same places.
  const uint32_t xat = opaque(base) + R::kOffX + r * 128 + 8 * (lane & 1);
  const auto at = [&](int n, int nb) {
    return xat + (4 * n + nb / 4) * kTileBytes + (((2 * (nb % 4) + q / 2) ^ (lane / 4)) << 4);
  };
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < R::kN; ++n) {
    float2 b[kBN / 8];  // loaded before the shared-memory reads, which clobber memory
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb)
      b[nb] = *reinterpret_cast<const float2*>(b2 + kBN * n + 8 * nb + 2 * q);
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 xv = mrd::lds_f32x2(at(n, nb) + half * 8 * 128);
        float& v0 = acc[n][4 * nb + 2 * half];
        float& v1 = acc[n][4 * nb + 2 * half + 1];
        v0 = v0 + b[nb].x + xv.x;
        v1 = v1 + b[nb].y + xv.y;
        sum[half] += v0 + v1;
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
  }
  float mu[2], rstd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mu[half] = sum[half] * (1.0f / kH);
    sum[half] = 0.0f;
  }
#pragma unroll
  for (int n = 0; n < R::kN; ++n) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float d = acc[n][i] - mu[(i / 2) % 2];
      sum[(i / 2) % 2] += d * d;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
    rstd[half] = rsqrtf(sum[half] * (1.0f / kH) + eps);
  }
#pragma unroll
  for (int n = 0; n < R::kN; ++n) {
    float2 g[kBN / 8], o[kBN / 8];  // before the stores, as b above
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
      g[nb] = *reinterpret_cast<const float2*>(gamma + kBN * n + 8 * nb + 2 * q);
      o[nb] = *reinterpret_cast<const float2*>(beta + kBN * n + 8 * nb + 2 * q);
    }
#pragma unroll
    for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * nb + 2 * half;
        mrd::sts_f32x2(at(n, nb) + half * 8 * 128,
                       (acc[n][i] - mu[half]) * rstd[half] * g[nb].x + o[nb].x,
                       (acc[n][i + 1] - mu[half]) * rstd[half] * g[nb].y + o[nb].y);
      }
    }
  }
  // this consumer's 64 rows of y go out by TMA (rows past M are not written)
  mrd::fence_proxy_async();
  mrd::named_bar_sync<128>(1 + wg);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int b = 0; b < kH / kBK; ++b)
      mrd::tma_store_2d(&y_map, base + R::kOffX + b * kTileBytes + wg * (kBM / kWG) * 128,
                        b * kBK, row0 + wg * (kBM / kWG));
    mrd::tma_store_commit();
    mrd::tma_store_wait();
  }
}

// y = LN2(x + GELU(x . W1 + b1) . W2 + b2) for M rows in two launches on
// `stream`: split_weights_rows into `scratch` (W1^T's planes, then W2^T's
// permuted planes: 4 F kH floats), then ffn_rows_f32, one block per 128
// rows.
template <int kH, bool kInputLN>
cudaError_t launch_ffn_rows(const float* z, const float* w1t, const float* b1, const float* w2t,
                            const float* b2, const float* gamma, const float* beta,
                            const float* g0, const float* o0, float* y, float* scratch, int M,
                            int F, float eps, cudaStream_t stream) {
  using R = FfnRowsF32<kH>;
  const long long fh = static_cast<long long>(F) * kH;
  float* w1_hi = scratch;
  float* w1_lo = w1_hi + fh;
  float* w2_hi = w1_lo + fh;
  float* w2_lo = w2_hi + fh;
  const long long threads = fh / 4 + fh / 8;
  split_weights_rows<<<static_cast<int>((threads + kSplitThreads - 1) / kSplitThreads),
                       kSplitThreads, 0, stream>>>(w1t, w2t, w1_hi, w1_lo, w2_hi, w2_lo, fh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap maps[6];
  if (!make_map_f32(&maps[0], z, M, kH, kBM) || !make_map_f32(&maps[1], w1_hi, F, kH, 64) ||
      !make_map_f32(&maps[2], w1_lo, F, kH, 64) || !make_map_f32(&maps[3], w2_hi, kH, F, kBN) ||
      !make_map_f32(&maps[4], w2_lo, kH, F, kBN) || !make_map_f32(&maps[5], y, M, kH, kBM / kWG))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ffn_rows_f32<kH, kInputLN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmemBytes);
  if (err != cudaSuccess) return err;
  ffn_rows_f32<kH, kInputLN><<<(M + kBM - 1) / kBM, kThreads, R::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], b1, b2, gamma, beta, g0, o0, M, F,
      eps);
  return cudaGetLastError();
}

}  // namespace
