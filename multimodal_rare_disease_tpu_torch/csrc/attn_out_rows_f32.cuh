// K3-f32's narrow forms (H = 128, 256, 384, 512 and 640) on Hopper: the
// whole row tile in one pass, y = LN(x + ctx . Wo^T + bo) with the
// LayerNorm in the product's epilogue, as the Pallas body does in VMEM
// (multimodal_rare_disease_tpu/ops/pallas/attn_out.py:38-47). Included by
// attn_out_ln_f32.cu after gemm_tf32x3.cuh.
//
// Why: at these widths the three-launch form (Wo's planes; the GEMM into
// f32 partials [M, H]; split_reduce_f32's LayerNorm) moves five [M, H] f32
// arrays (ctx, the partials twice, x, y) where the function needs three, and
// each 128 x 128 tile walks only H / 32 = 4-20 k-tiles, so its ring fill and
// its partial store are paid per tile with nothing to overlap them.
//
// Design: a cluster of H / 128 blocks (1-5) holds whole rows: block `rank`
// owns the 128 output columns rank * 128 .. of a tile of 128 rows, with
// gemm_tf32x3's producer thread and consumer warpgroups, its 3xTF32
// products in its order and its windows of 8 k-tiles, so the pre-LayerNorm
// sums are the three-launch form's bit for bit. What bounds gemm_tf32x3's k
// loop on the H100 is shared memory's bandwidth (~2,100-2,240 clk a k-tile
// against ~1,540 of tensor-core work, PERF.md): a k-tile moves TMA's 48 KB
// in, the split's 48 KB and the three products' 144 KB of operand reads.
// Here each consumer thread loads its wgmma fragment of ctx once per k8
// step, splits it into the TF32 planes in registers and the three products
// take A from registers (consume_rs), so no A plane passes through shared
// memory (~1,850 clk a k-tile). The clusters are persistent: as many as the
// card holds at once (cudaOccupancyMaxActiveClusters) walk the row tiles, so
// the producer fills the ring with the next tile's k-tiles while the
// consumers finish the last. x comes into a buffer of its own by TMA while
// the tile's last k-tiles run; the consumers add bo and x to their
// accumulators, and y is written over x (each thread over the elements it
// read) and stored by TMA, which reads it while the next tile's k loop
// runs; the buffer is released after that tile's second k-tile. The
// LayerNorm's two row sums (the sums, then the centred squares) go to the
// cluster's other blocks by st.async into a buffer of theirs, counted on a
// barrier of each consumer warpgroup that is armed for the peers' bytes
// and re-armed two tiles on (as attn_out_ln.cuh's cluster of four). Every
// block adds the blocks' partials in rank order, so the blocks of a row
// share mean and rstd bit for bit. No partials, no second pass, no atomics:
// the same bits on every launch. Rows past M read as zeros (TMA) and are not
// stored.
// Shared memory: the ring (3 stages of ctx and Wo^T's planes, 48 KB each),
// x / y (64 KB), the exchange (2 KB a block of the cluster) and the
// barriers: 210-218 KB.

#pragma once

#include <cuda.h>

#include "gemm_tf32x3.cuh"

namespace {

using mrd::fence_regs;
using mrd::map_to_rank;
using mrd::st_async_f32;

// The narrow form at hidden width kH
template <int kH>
struct RowsF32 {
  static constexpr int kC = kH / kBN;                         // blocks a cluster
  static constexpr int kK = kH / kBK;                         // k-tiles a tile
  // registers a consumer and a producer thread hold (setmaxnreg): 240 / 24
  // from two whole windows up (512, 640), 232 / 40 below; ptxas spilled at
  // 512 and 640 with 232 / 40 and at 384 with 240 / 24
  static constexpr int kRegs = kK >= 2 * kWindow ? 240 : kConsumerRegs;
  static constexpr int kProducerRegs = kK >= 2 * kWindow ? 24 : ::kProducerRegs;
  // a stage: ctx's k-tile in f32 [128 rows][32], then Wo^T's hi and lo
  // planes [128 columns][32], in the 128-byte swizzle
  static constexpr uint32_t kStage = 3 * kTileBytes;          // 48 KB
  static constexpr uint32_t kExBytes = kBM * 4;               // a block's row partials
  static constexpr uint32_t kExRecv = (kC - 1) * (kBM / kWG) * 4;  // a consumer's, from the peers
  // the ring, x / y as four [128 rows][32] boxes, the exchange, f32
  // [buffer][sums, centred squares][rank from][128 rows], and the barriers:
  // the stages' full (TMA bytes) and empty (every consumer warp); x's full
  // (TMA bytes) and free (each consumer's y store read); the exchange's
  // [buffer][sums, centred squares][consumer]
  static constexpr uint32_t kOffX = kStages * kStage;
  static constexpr uint32_t kOffRed = kOffX + 4 * kTileBytes;
  static constexpr uint32_t kBarFull = kOffRed + 2 * 2 * kC * kExBytes;
  static constexpr uint32_t kBarEmpty = kBarFull + 8 * kStages;
  static constexpr uint32_t kBarXFull = kBarEmpty + 8 * kStages;
  static constexpr uint32_t kBarXFree = kBarXFull + 8;
  static constexpr uint32_t kBarStats = kBarXFree + 8;
  static constexpr uint32_t kSmemBytes = kBarStats + 8 * 2 * 2 * kWG + 1024;
  static_assert(kWholeTiles<kH> && kC >= 1 && kC <= 5, "a cluster of whole column tiles");
  static_assert(kStage % 1024 == 0 && kOffX % 1024 == 0, "1024-byte swizzle atoms");
  static_assert(2 * 128 * kRegs + 128 * kProducerRegs == kThreads * 168,
                "setmaxnreg must hand over exactly the registers it frees");
  static_assert(kSmemBytes <= 232448, "over the per-block shared memory");
};

// The producer thread: for each row tile of the cluster (every gridDim.x-th
// from blockIdx.x) its k-tiles (ctx in f32, Wo^T's planes of the block's
// columns col0 ..), then, once the tile before's y store has read x's
// buffer, x's block of the tile.
template <int kH>
__device__ __forceinline__ void produce_rows(const CUtensorMap* ctx, const CUtensorMap* x,
                                             const CUtensorMap* b_hi, const CUtensorMap* b_lo,
                                             uint32_t base, int col0, int n_tiles) {
  using R = RowsF32<kH>;
  Ring ring;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++it) {
    const int row0 = t * kBM;
    for (int k = 0; k < R::kK; ++k) {
      mbar_wait(base + R::kBarEmpty + 8 * ring.slot, ring.phase ^ 1);
      const uint32_t full = base + R::kBarFull + 8 * ring.slot;
      const uint32_t dst = base + ring.slot * R::kStage;
      mbar_arrive_expect_tx(full, R::kStage);
      tma_load_2d(dst, ctx, full, k * kBK, row0);
      tma_load_2d(dst + kTileBytes, b_hi, full, k * kBK, col0);
      tma_load_2d(dst + 2 * kTileBytes, b_lo, full, k * kBK, col0);
      ring.next<kStages>();
    }
    if (it > 0) mbar_wait(base + R::kBarXFree, (it - 1) & 1);
    const uint32_t full = base + R::kBarXFull;
    mbar_arrive_expect_tx(full, 4 * kTileBytes);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      tma_load_2d(base + R::kOffX + b * kTileBytes, x, full, col0 + b * kBK, row0);
  }
}

// Consumer wg's share of one k-tile: for each of its 4 k8 steps the thread
// loads its wgmma fragment of the stage's f32 ctx (rows r = 64 wg + 16 (warp
// % 4) + lane / 4 and r + 8, k columns 8 kk + lane % 4 and + 4: in the
// 128-byte swizzle, 16-byte group 2 kk or 2 kk + 1 of the row, ^ (r % 8) =
// lane / 4), splits it as split4 does (hi = tf32(v), lo = v - hi) into
// a[kk % 2], and issues big += A_hi . B_hi, small += A_hi . B_lo + A_lo .
// B_hi as one group with A from registers: consume's products, operands and
// order, so its sums. After each group the one before is retired
// (wgmma_wait<1>), which frees its registers (the other half of `a`) and,
// at the first step, the previous stage (one arrival per warp). kFirst: the
// first k-tile of a window.
template <int kH, bool kFirst>
__device__ __forceinline__ void consume_rs(float (&big)[64], float (&small)[64],
                                           uint32_t (&a)[2][8], Ring& ring, uint32_t& prev,
                                           uint32_t base, int wg, int warp, int lane,
                                           bool signal) {
  using R = RowsF32<kH>;
  mbar_wait(base + R::kBarFull + 8 * ring.slot, ring.phase);
  const uint32_t st = opaque(base) + ring.slot * R::kStage;
  const uint32_t row = st + (64 * wg + 16 * (warp % 4) + lane / 4) * 128 + 4 * (lane % 4);
  const uint32_t b_hi = st + kTileBytes, b_lo = st + 2 * kTileBytes;
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    uint32_t(&f)[8] = a[kk % 2];
    const uint32_t c0 = row + (((2 * kk) ^ (lane / 4)) << 4);
    const uint32_t c1 = row + (((2 * kk + 1) ^ (lane / 4)) << 4);
    const float v[4] = {mrd::ld_shared_f32(c0), mrd::ld_shared_f32(c0 + 8 * 128),
                        mrd::ld_shared_f32(c1), mrd::ld_shared_f32(c1 + 8 * 128)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float hi = tf32_rna(v[i]);
      f[i] = __float_as_uint(hi);
      f[4 + i] = __float_as_uint(v[i] - hi);
    }
    const uint32_t(&hi)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&f[0]);
    const uint32_t(&lo)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&f[4]);
    fence_regs(f);
    mrd::fence_operand(big);
    mrd::fence_operand(small);
    mrd::wgmma_fence();
    const uint64_t dbh = sw128_desc(b_hi + kk * 32), dbl = sw128_desc(b_lo + kk * 32);
    if (kFirst && kk == 0) {
      mrd::wgmma_m64n128k8_tf32_rs_first(big, hi, dbh);
      mrd::wgmma_m64n128k8_tf32_rs_first(small, hi, dbl);
    } else {
      mrd::wgmma_m64n128k8_tf32_rs(big, hi, dbh, 1);
      mrd::wgmma_m64n128k8_tf32_rs(small, hi, dbl, 1);
    }
    mrd::wgmma_m64n128k8_tf32_rs(small, lo, dbh, 1);
    mrd::wgmma_commit();
    mrd::fence_operand(big);
    mrd::fence_operand(small);
    if (!kFirst || kk > 0) {
      mrd::wgmma_wait<1>();
      fence_regs(a[(kk + 1) % 2]);
      if (kk == 0 && signal) mbar_arrive(base + R::kBarEmpty + 8 * prev);
    }
  }
  prev = ring.slot;
  ring.next<kStages>();
}

// A row's total over the cluster for one LayerNorm exchange, for the
// thread's two rows (r, r + 8 of the tile; `s` its block's partials, the
// same in the four lanes of a row). `red` is this block's exchange of the
// kind and buffer, [rank from][128 rows], and `bar` the consumer's barrier,
// armed for the peers' bytes: the writers (lane % 4 == 0) store theirs into
// each peer's `red` by st.async, counted on the peer's barrier; once this
// block's has every peer's, each thread adds the blocks' partials in rank
// order. The barrier is armed again for its next use, two tiles on.
template <int kH>
__device__ __forceinline__ void rows_total(float (&s)[2], uint32_t red, uint32_t bar,
                                           uint32_t parity, int rank, int lane, int r,
                                           bool rearm, bool arms) {
  using R = RowsF32<kH>;
  const uint32_t mine = red + rank * R::kExBytes + 4 * r;
  if (lane % 4 == 0) {
#pragma unroll
    for (int p = 1; p < R::kC; ++p) {
      const uint32_t peer = (rank + p) % R::kC;
      const uint32_t at = map_to_rank(mine, peer), peer_bar = map_to_rank(bar, peer);
      st_async_f32(at, s[0], peer_bar);
      st_async_f32(at + 8 * 4, s[1], peer_bar);
    }
  }
  mrd::mbar_wait_cluster(bar, parity);
  if (rearm && arms) mbar_arrive_expect_tx(bar, R::kExRecv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v = 0.0f;
#pragma unroll
    for (int p = 0; p < R::kC; ++p)
      v += p == rank ? s[half]
                     : mrd::ld_shared_f32(red + p * R::kExBytes + 4 * (r + 8 * half));
    s[half] = v;
  }
}

// Grid: (clusters, 1, kH / 128), clusters of the column tiles (grid z) of a
// row tile; each cluster walks the row tiles from blockIdx.x in steps of
// gridDim.x. Per tile each block runs the k loop for its columns, adds bo
// and x, takes the LayerNorm's row statistics over the cluster and stores
// y.
template <int kH>
__global__ void __launch_bounds__(kThreads, 1)
attn_out_rows_f32(const __grid_constant__ CUtensorMap ctx_map,   // ctx [M, H] f32
                  const __grid_constant__ CUtensorMap x_map,     // x [M, H] f32
                  const __grid_constant__ CUtensorMap b_hi_map,  // Wo^T's planes [H, H]
                  const __grid_constant__ CUtensorMap b_lo_map,
                  const __grid_constant__ CUtensorMap y_map,     // y [M, H], [64][32] boxes
                  const float* __restrict__ bo, const float* __restrict__ gamma,
                  const float* __restrict__ beta, int M, float eps) {
  using R = RowsF32<kH>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int rank = static_cast<int>(mrd::cluster_ctarank());  // the block's column tile (grid z)
  const int col0 = rank * kBN;
  const int n_tiles = (M + kBM - 1) / kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + R::kBarFull + 8 * s, 1);
      mbar_init(base + R::kBarEmpty + 8 * s, kWG * 4);  // every consumer warp
    }
    mbar_init(base + R::kBarXFull, 1);
    mbar_init(base + R::kBarXFree, kWG);
    // the exchange barriers, armed for the first two tiles
    if constexpr (R::kC > 1)
      for (int s = 0; s < 2 * 2 * kWG; ++s) {
        mbar_init(base + R::kBarStats + 8 * s, 1);
        mbar_arrive_expect_tx(base + R::kBarStats + 8 * s, R::kExRecv);
      }
    fence_barrier_init();
  }
  mrd::cluster_sync();  // every block's barriers are initialized

  if (threadIdx.x / 128 == kWG) {
    // ---- the producer warpgroup: one thread issues every TMA load
    mrd::setmaxnreg_dec<R::kProducerRegs>();
    if (threadIdx.x == 128 * kWG)
      produce_rows<kH>(&ctx_map, &x_map, &b_hi_map, &b_lo_map, base, col0, n_tiles);
  } else {
    // ---- consumer wg: rows 64 wg .. + 64 of each tile, the block's columns
    mrd::setmaxnreg_inc<R::kRegs>();
    const int wg = threadIdx.x / 128;
    const bool signal = lane == 0;  // one arrival per warp
    const bool stores = threadIdx.x % 128 == 0;  // issues the consumer's y stores
    float big[64], small[64], total[64];
    uint32_t a[2][8];  // ctx's planes of two k8 steps
    Ring ring;
    uint32_t prev = 0;
    for (int it = 0;; ++it) {
      const int t = blockIdx.x + it * gridDim.x;
      if (t >= n_tiles) break;
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] = 0.0f;
      for (int t0 = 0; t0 < R::kK; t0 += kWindow) {
        const int t1 = min(t0 + kWindow, R::kK);
        consume_rs<kH, true>(big, small, a, ring, prev, base, wg, warp, lane, signal);
        for (int k = t0 + 1; k < t1; ++k) {
          consume_rs<kH, false>(big, small, a, ring, prev, base, wg, warp, lane, signal);
          if (k == 1 && it > 0 && stores) {
            // the tile before's y has left x's buffer
            mrd::tma_store_wait();
            mbar_arrive(base + R::kBarXFree);
          }
        }
        mrd::wgmma_wait<0>();
        mrd::fence_operand(big);
        mrd::fence_operand(small);
        fence_regs(a[0]);
        fence_regs(a[1]);
        if (signal) mbar_arrive(base + R::kBarEmpty + 8 * prev);
#pragma unroll
        for (int i = 0; i < 64; ++i) total[i] += big[i] + small[i];
      }

      // ---- epilogue. Thread (warp, lane) holds rows r and r + 8 of the
      // tile and, per n8 block nb, the block's columns c = 8 nb + 2 (lane %
      // 4) and + 1: total[4 nb + 2 half + e] is (r + 8 half, c + e). In x's
      // buffer column c lies in box c / 32, 16-byte group (c % 32) / 4 of its
      // 128-byte row, which the swizzle moves to that group ^ (row % 8);
      // row % 8 is lane / 4 for both rows. y goes over x at the same places.
      const int r = 64 * wg + 16 * (warp % 4) + lane / 4;
      mbar_wait(base + R::kBarXFull, it & 1);
      const uint32_t xrow = opaque(base) + R::kOffX + r * 128 + 8 * (lane & 1);
      const auto at = [&](int nb) {
        return xrow + (nb / 4) * kTileBytes + (((2 * (nb % 4) + (lane % 4) / 2) ^ (lane / 4)) << 4);
      };
      float s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb) {
        const int c = 8 * nb + 2 * (lane % 4);
        const float2 b = *reinterpret_cast<const float2*>(bo + col0 + c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 xv = mrd::lds_f32x2(at(nb) + half * 8 * 128);
          float& a0 = total[4 * nb + 2 * half];
          float& a1 = total[4 * nb + 2 * half + 1];
          a0 = a0 + b.x + xv.x;
          a1 = a1 + b.y + xv.y;
          s[half] += a0 + a1;
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
      }
      // over the cluster: this tile's exchange buffer and barriers (this
      // consumer's; `kind` 1 the centred squares), their phase, and
      // whether they serve the tile two on
      const auto over_cluster = [&](int kind) {
        if constexpr (R::kC > 1) {
          const uint32_t buf = it & 1, parity = (it >> 1) & 1;
          const uint32_t red = base + R::kOffRed + (buf * 2 + kind) * R::kC * R::kExBytes;
          const uint32_t bar = base + R::kBarStats + 8 * ((buf * 2 + kind) * kWG + wg);
          const bool rearm = t + 2 * static_cast<int>(gridDim.x) < n_tiles;
          rows_total<kH>(s, red, bar, parity, rank, lane, r, rearm, stores);
        }
      };
      over_cluster(0);
      float mu[2], rstd[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mu[half] = s[half] * (1.0f / kH);
        s[half] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float d = total[i] - mu[(i / 2) % 2];
        s[(i / 2) % 2] += d * d;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
      }
      over_cluster(1);
#pragma unroll
      for (int half = 0; half < 2; ++half) rstd[half] = rsqrtf(s[half] * (1.0f / kH) + eps);
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb) {
        const int c = 8 * nb + 2 * (lane % 4);
        const float2 g = *reinterpret_cast<const float2*>(gamma + col0 + c);
        const float2 o = *reinterpret_cast<const float2*>(beta + col0 + c);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 4 * nb + 2 * half;
          mrd::sts_f32x2(at(nb) + half * 8 * 128,
                         (total[i] - mu[half]) * rstd[half] * g.x + o.x,
                         (total[i + 1] - mu[half]) * rstd[half] * g.y + o.y);
        }
      }
      // this consumer's 64 rows of y go out by TMA (rows past M are not
      // written); x's buffer is released once they have been read
      mrd::fence_proxy_async();
      mrd::named_bar_sync<128>(1 + wg);
      if (stores) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          mrd::tma_store_2d(&y_map, base + R::kOffX + b * kTileBytes + wg * (kBM / kWG) * 128,
                            col0 + b * kBK, t * kBM + wg * (kBM / kWG));
        mrd::tma_store_commit();
      }
    }
    if (stores) mrd::tma_store_wait();
  }
  mrd::cluster_sync();  // no peer stores into this block's exchange any more
}

// A launch of attn_out_rows_f32<kH>: clusters of kH / 128 blocks along grid
// z, `clusters` of them along x
template <int kH>
void rows_config(cudaLaunchConfig_t& config, cudaLaunchAttribute& attr, int clusters,
                 cudaStream_t stream) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = RowsF32<kH>::kC;
  config = {};
  config.gridDim = dim3(clusters, 1, RowsF32<kH>::kC);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = RowsF32<kH>::kSmemBytes;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
}

// Clusters of attn_out_rows_f32<kH> the card holds at once (read once), or
// 0 if the runtime cannot say
template <int kH>
int rows_resident() {
  static const int n = [] {
    if (cudaFuncSetAttribute(attn_out_rows_f32<kH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(RowsF32<kH>::kSmemBytes)) != cudaSuccess)
      return 0;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t config;
    rows_config<kH>(config, attr, 1, nullptr);
    int c = 0;
    return cudaOccupancyMaxActiveClusters(&c, attn_out_rows_f32<kH>, &config) == cudaSuccess ? c
                                                                                             : 0;
  }();
  return n;
}

// y = LN(x + ctx . Wo^T + bo) for M rows in one launch of attn_out_rows_f32
// on `stream`, Wo^T as its planes w_hi, w_lo: as many clusters as the card
// holds, at most one per row tile.
template <int kH>
cudaError_t launch_rows(const float* ctx, const float* x, const float* w_hi, const float* w_lo,
                        const float* bo, const float* gamma, const float* beta, float* y, int M,
                        float eps, cudaStream_t stream) {
  CUtensorMap maps[5];
  if (!make_map_f32(&maps[0], ctx, M, kH, kBM) || !make_map_f32(&maps[1], x, M, kH, kBM) ||
      !make_map_f32(&maps[2], w_hi, kH, kH, kBN) || !make_map_f32(&maps[3], w_lo, kH, kH, kBN) ||
      !make_map_f32(&maps[4], y, M, kH, kBM / kWG))
    return cudaErrorInvalidValue;
  const int resident = rows_resident<kH>();
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (M + kBM - 1) / kBM;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  rows_config<kH>(config, attr, tiles < resident ? tiles : resident, stream);
  return cudaLaunchKernelEx(&config, attn_out_rows_f32<kH>, maps[0], maps[1], maps[2], maps[3],
                            maps[4], bo, gamma, beta, M, eps);
}

}  // namespace
