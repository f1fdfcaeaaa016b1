// K3: the post-LN BERT attention-output sublayer, written by hand for Hopper
// (sm_90a):
//
//   y = bf16(LN(f32(x) + ctx . Wo^T + bo))   ctx, x: [M, H] bf16; Wo: [H, H]
//                                             bf16 in torch.nn.Linear's [out, in]
//
// H is a template parameter, built for 768 (BERT-base; the design below),
// 1,024 (BERT-large), 512, 256 and 128 (the compact BERTs), 384 (MiniLM),
// 640 and 896, and 1,152, 1,280, 1,408 and 1,536; their changes are at the
// end of this comment. This header holds the kernels and the macro of their
// C entries; attn_out_ln.cu instantiates them up to 1,024 but 128 and 640,
// attn_out_ln_overlap.cu at 128 and 640 and attn_out_ln_wide.cu above
// 1,024, so that build.py's nvccs compile the three in parallel.
//
// The product accumulates in f32 and is not rounded; bo and the residual x
// are added in f32 before the two-pass f32 LayerNorm (eps given, 1e-12 for
// BERT). bo and the LayerNorm parameters are bf16 (a model cast to bf16
// passes its own), widened to f32 on load.
//
// Replaces multimodal_rare_disease_tpu/ops/pallas/attn_out.py::
// _attn_out_ln_kernel (reached through _fused_attn_out_ln_impl and
// fused_attn_out_ln), with its numerics contract (attn_out.py:12-17).
//
// What bounds it on the H100: at the packed batch of 256 documents (M =
// 16,384) one call moves 76.7 MB (ctx, x and y, 25.2 MB each, plus Wo) and
// does 2*M*768*768 = 19.3 GFLOP: 0.0229 ms at 3.35 TB/s against 0.0195 ms
// at the bf16 tensor-core peak. The two are close, so the product has to run
// near the tensor-core rate, which only wgmma reaches. Every block that owns
// a tile of rows reads all of Wo (1.18 MB) from L2, so the rows per block
// set the L2-to-SM traffic: 604 MB per call at 32 rows, 302 MB at 64. LN
// needs whole 768-wide rows, so a 64-row tile keeps a [64, 768] f32
// accumulator in registers.
// Few rows (a single request's 64) leave all but one SM idle.
//
// Design:
//   - a block owns 64 rows (one wgmma M) and three warpgroups: two consumers
//     and one producer. setmaxnreg gives each consumer 232 registers (its 192
//     accumulator registers stay pinned) and the producer 40: 2 x 128 x 232 +
//     128 x 40 = 384 x 168, the registers the block is launched with;
//   - the ctx tile [64, 768] (96 KB) is loaded by TMA as 12 column blocks of
//     [64][64] in the 128-byte swizzle layout, one mbarrier each: wgmma's A
//     operand, read through sw128_desc. Rows past M read as zeros;
//   - consumer wg owns output columns 384 wg .. +384: per k chunk of 64 it
//     takes three Wo tiles [128 out x 64 k] (nn.Linear's [out, in] rows are
//     the K-major B operand, no transpose) and runs wgmma m64n128k16 into its
//     [64, 384] f32 accumulator, one wgmma group in flight;
//   - one producer thread issues every TMA load. Wo streams through a ring of
//     4 slots of 16 KB per consumer with full (TMA bytes) and empty (one
//     arrival per consumer warp) mbarriers; the consumers only arrive on
//     "empty", so neither side waits for the other to refill;
//   - the residual x goes into the freed ctx blocks: once both consumers are
//     done with k chunk c, ctx block c is dead and the producer loads x's
//     column block c into it (two chunks behind the Wo stream), so x arrives
//     in the same swizzled layout while the product runs, at no extra shared
//     memory and with no uncoalesced loads;
//   - the epilogue works from the registers: + bo + x (from shared memory),
//     then LN with per-row partial sums exchanged between the two consumers
//     through shared memory (two-pass); y is written as bf16 over x in shared
//     memory and stored by TMA, which skips the rows past M.
// Split-K path for few rows: when the row tiles would fill fewer blocks than
// the card has SMs, the launch adds a grid dimension of S slices of the 12 k
// chunks (S chosen by kernels/attn_out.py::attn_out_plan). Each block then
// runs its slice's chunks only and stores its f32 partial of ctx . Wo^T for
// the valid rows into a scratch buffer [S, M, 768]; split_reduce (rows.cuh,
// shared with the FFN kernel) sums the S partials in slice order, adds bo and
// x and applies LN. No atomics: the result is the same bits on every launch.
// A cluster of two blocks that share each Wo tile by TMA multicast halves the
// L2 reads of Wo; on the H100 it took longer than this design (PERF.md), so
// it is not built here.
//
// H = 1,024: consumers of [64, 512] would need 256 accumulator floats a
// thread, and the 128-KB ctx tile beside the two 64-KB Wo rings is 256 KB
// against 227 KB. So a row tile is cut into two column groups of 512 output
// columns, one block each (grid z), run as a cluster of two:
//   - both blocks need the whole ctx tile (16 column blocks, the product's
//     k): block r's producer loads the column blocks c with c % 2 == r by
//     TMA multicast into both blocks, and each block's producer expects
//     the bytes of every block on its own barrier;
//   - the consumers run [64, 256] each (128 accumulator floats), with Wo
//     rings of 3 slots (224 KB in all), and x's column blocks of the
//     block's own columns replace ctx's as above;
//   - LN over the pair: the row sums of each consumer's 256 columns go into
//     the block's own exchange, an arrival on the peer's barrier says they
//     are there, and each block reads the peer's over distributed shared
//     memory (ld.shared::cluster) and adds the four partials of a row in
//     one order, so both get the same mean; the centred squares the same
//     way; each block then writes y for its 512 columns by TMA;
//   - a cluster barrier after the barriers' initialization (before any
//     multicast or remote access) and before exit.
// With the k chunks split (small M), each block stores its f32 partial and
// split_reduce finishes the rows, as above.
//
// H = 512, 256 and 128 (google-research/bert's BERT-Medium, -Mini and
// -Tiny): one block per row tile, as at 768, with 8, 4 and 2 k chunks and
// consumers of [64, 256], [64, 128] and [64, 64]. At 128 a consumer's 64
// columns are less than one n128 Wo tile, so Wo is read as [64 out x 64 k]
// tiles (8 KB) and the consumers run wgmma m64n64k16, in the tile form
// below (AttnOut<128> gives it these shapes; this kernel is not built at
// 128); the two consumers, their split and the LN exchange stay. Each width's
// variant is under `if constexpr`, so the 768 and 1,024 code is compiled
// as it was.
//
// H = 384, 640 and 896, the odd multiples of 128 below 1,024. 384 and 640
// are one block per row tile with consumers of [64, 192] and [64, 320]:
// Wo tiles of 64 as at 128, 3 and 5 per consumer and chunk. At 896 a
// consumer of [64, 448] would need 224 accumulator floats a thread, so 896
// is 1,024's pair with 448 columns per block (ctx multicast, LN over
// distributed shared memory; 14 k chunks, 3 Wo slots of 14 KB per
// consumer). Its consumers own 224 contiguous columns each, as two Wo
// tiles of 112 on wgmma m64n112k16 (64 does not divide 224). 224 columns
// end in the middle of a 64-column block, so the consumers share the
// block they meet in: each waits for x in every block its columns touch,
// finds its elements from eight group bases that start at its first
// column's group, and the block's y goes out by TMA from one thread once
// both consumers have written it.
//
// H = 1,152, 1,280, 1,408 and 1,536 (above BERT-large; 1,536 is
// microsoft/deberta-v2-xlarge's width): 1,024's pair, but the row tile no
// longer stays resident: at 1,536 the ctx tile alone is 192 KB, and two
// Wo rings of 2 x 16 KB beside it make 256 KB. So ctx streams through a
// ring of 4 column blocks (8 KB each; full and empty barriers, the empty
// one taking every consumer warp), and x and y keep only the block's own
// columns, in a region of their own (96 KB at 1,536) that x fills by TMA
// from the third chunk on. Each block loads every ctx block itself: a
// multicast into both blocks' rings would need each slot's release from
// both blocks' consumers, and would save a block 64 x H of its L2 reads
// against the H x H / 2 of Wo it reads (4% at 1,536). The consumers own
// 288, 320, 352 and 384 columns, as Wo tiles of 96, 64, 88 and 128
// (1,152's and 1,408's consumers meet inside a column block, as 896's
// do); the LN over the pair, the y stores and the split path are 1,024's.
// Shared memory at 1,536: x 96 KB, ctx ring 32, Wo rings 96: 224 KB.
//
// The whole k loop from H = 896 up: the cluster of four (attn_out_quad_kernel).
// In the pair each block reads its half of Wo from L2 for 64 rows: 64 FLOP
// a byte, and on the H100 the Wo stream alone took 58-65% of the pair's
// time and a tile's epilogue 31-46% (PERF.md). So a block owns 128
// rows (64 a consumer) and a quarter of the columns, the pair's consumer
// slice: both consumers run wgmma on the same Wo tile, each on its own
// rows of ctx ([128][64] a chunk, through a ring of its own), so each Wo
// byte serves 128 rows and L2 sends an SM 64 KB a chunk at 1,536, not 104.
// The four quarters of a group of 128 rows are one cluster; the LN sends
// each row's partials to the peers by st.async and adds the four as (q0 +
// q1) + (q2 + q3), the pair's order, so the bits are the pair's. Only 30
// clusters of four fit the H100 at once (66 pairs), so the grid is
// persistent: each cluster walks the row groups, its producer loading the
// next group's ctx and Wo while the consumers finish the last one, and the
// y store of one group is waited for during the next. x and y sit in
// [128][32] blocks in the 64-byte swizzle layout (a quarter is a multiple
// of 32 columns, not of 64), x loaded one block a chunk. 1,280's consumers
// take two n160 tiles (the pair's five n64 tiles ran at ~100 clk a step).
// Where 30 clusters take more rounds than 66 pairs take waves by more
// than a group's lower cost makes up (quad_clusters: below ~8,448 rows at
// 896, 1,024 and 1,536), and on the split path, the pair runs.
//
// The overlapped form at H = 640 and the tile form at 128
// (attn_out_ln_overlap.cu builds them; the C entry's `slices` 0 asks for
// them). The one-block form's tile runs its epilogue, x's round trip and
// the y store with nothing beside it (43% of its time at 640, 75% at 128
// on the H100; PERF.md), and at 640 its consumers step through n64 Wo
// tiles at ~100 clk a step and every 64-row tile reads all of Wo from L2.
// At 640, where the k loop stays whole (kernels/attn_out.py::overlap_form;
// the split path keeps the one-block form), the cluster-of-four kernel
// runs in clusters of two (66 fit the H100): a block owns 128 rows by 320
// columns, 1,280's quarter, on n160 tiles, and x loads two blocks a chunk;
// the LN adds half 0 + half 1, the one-block form's order (its consumer
// 0's columns, then consumer 1's), so y is that form's bits. At 128, at
// every M (it beat the one-block form's split path too), and the width's
// only form, attn_out_tile_kernel: the one-block form's tile and epilogue
// with x in a space of its own, every load issued at the start and no
// producer warpgroup, three blocks an SM.

#pragma once

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"
#include "rows.cuh"

namespace {

using mrd::bf16;
using mrd::fence_barrier_init;
using mrd::fence_proxy_async;
using mrd::mbar_arrive;
using mrd::mbar_arrive_expect_tx;
using mrd::mbar_init;
using mrd::mbar_wait;
using mrd::named_bar_sync;
using mrd::opaque;
using mrd::Ring;
using mrd::smem_addr;
using mrd::sts_pair;
using mrd::sw128_desc;
using mrd::tma_load_2d;

constexpr int kTM = 64;                   // rows per block (wgmma M)
constexpr int kKC = 64;                   // k chunk: one ctx column block
constexpr int kWG = 2;                    // consumer warpgroups (0, 1); the producer is 2
constexpr int kThreads = 128 * (kWG + 1);
constexpr int kConsumerThreads = 128 * kWG;
constexpr int kXLag = 2;                  // x block c loads after chunk c + 2's Wo tiles
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr uint32_t kBlockBytes = kTM * 128;                    // 8 KB

// The shape of the kernel at hidden width kH: 768 as the header sets out,
// 1,024 and 896 in two column groups of 512 and 448 (one block each), 512,
// 384, 256 and 128 as 768 with narrower consumers, and the widths above
// 1,024 as 1,024's pair with ctx streamed (kWide).
template <int kH>
struct AttnOut {
  static_assert(kH == 128 || kH == 256 || kH == 384 || kH == 512 || kH == 640 ||
                    kH == 768 || kH == 896 || kH == 1024 || kH == 1152 || kH == 1280 ||
                    kH == 1408 || kH == 1536,
                "a width the kernel is built for");
  static constexpr int kGroups = kH >= 896 ? 2 : 1;  // blocks per row tile
  static constexpr bool kPair = kGroups == 2;        // a cluster sharing ctx and LN
  static constexpr bool kWide = kH > 1024;           // ctx streamed, x and y the block's own
  static constexpr int kCols = kH / kGroups;         // output columns per block
  static constexpr int kChunks = kH / kKC;           // 12 / 16
  static constexpr int kHalf = kCols / kWG;          // 384 / 256 output columns per consumer
  // output columns of a Wo tile (wgmma N): 64 where a consumer's columns
  // are an odd multiple of 64, 112 at 896, 96 at 1,152, 88 at 1,408
  static constexpr int kN = kH == 896    ? 112
                            : kH == 1152 ? 96
                            : kH == 1408 ? 88
                                         : (kHalf % 128 != 0 ? 64 : 128);
  static constexpr int kAcc = kN / 2;                // accumulator floats per Wo tile
  static constexpr uint32_t kTileBytes = kN * kKC * 2;  // 16 KB (8 KB at 128)
  static constexpr int kTiles = kHalf / kN;          // 3 / 2 Wo tiles per consumer and chunk
  static constexpr int kStages = kPair ? 3 : 4;      // Wo ring slots per consumer
  // kWide: x's column blocks a block holds, and the ctx ring's slots
  static constexpr int kOwn = kCols / kKC;
  static constexpr int kCtxStages = 4;

  // shared memory, from a 1024-byte aligned base: the row tile (ctx, then
  // x, then y) as kChunks column blocks of [64 rows][64 bf16] (kWide: x,
  // then y, as kOwn blocks, then the ctx ring), the two Wo rings, the
  // barriers and the LN exchange
  static constexpr uint32_t kOffA = 0;
  static constexpr uint32_t kOffC = kOffA + (kWide ? kOwn : kChunks) * kBlockBytes;
  static constexpr uint32_t kOffW = kOffC + (kWide ? kCtxStages * kBlockBytes : 0);
  // per column block: full (TMA bytes; phase 0 ctx, phase 1 x) and empty
  // (every consumer warp, once it is done with ctx); kWide: per block of x
  // a full barrier, then the ctx ring's full and empty barriers; per Wo
  // slot: full and empty
  static constexpr uint32_t kBarAFull = kOffW + kWG * kStages * kTileBytes;
  static constexpr uint32_t kBarAEmpty = kBarAFull + 8 * (kWide ? kOwn : kChunks);
  static constexpr uint32_t kBarCFull = kBarAEmpty;
  static constexpr uint32_t kBarCEmpty = kBarCFull + 8 * kCtxStages;
  static constexpr uint32_t kBarWFull = kBarAEmpty + 8 * (kWide ? 2 * kCtxStages : kChunks);
  static constexpr uint32_t kBarWEmpty = kBarWFull + 8 * kWG * kStages;
  // the pair's LN exchange: the barriers that the peer's row sums and
  // centred squares are in its `red`
  static constexpr uint32_t kBarStats = kBarWEmpty + 8 * kWG * kStages;
  static constexpr uint32_t kOffRed = kBarStats + (kPair ? 16 : 0);  // float [2][2][64]
  static constexpr uint32_t kSmemBytes = kOffRed + 2 * kWG * kTM * 4 + 1024;

  static_assert(kH % kKC == 0 && kHalf % kN == 0, "whole Wo tiles per consumer");
  static_assert(kOffW % 1024 == 0 && kBlockBytes % 1024 == 0 && kTileBytes % 1024 == 0,
                "1024-byte swizzle atoms");
  static_assert(kSmemBytes <= 232448, "over the per-block shared memory");
};

static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs == kThreads * 168,
              "setmaxnreg must hand over exactly the registers it frees");

// columns c, c + 1 (c even) of a bf16 row, as f32
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// two bf16 at a shared-memory address, as f32 (mrd::sts_pair stores them)
__device__ __forceinline__ float2 lds_pair(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// two bf16 to a shared-memory address (as mrd::sts_pair) without a memory
// clobber: the cluster of four's epilogue loads gamma and beta beside y's
// stores
__device__ __forceinline__ void sts_pair_free(uint32_t addr, __nv_bfloat162 v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(*reinterpret_cast<uint32_t*>(&v)));
}

// x's column block c into the row tile, over ctx's, once both consumers are
// done with it (fused LN only; the pair: the block's own columns only)
template <int kH>
__device__ __forceinline__ void load_x(const CUtensorMap* x_map, uint32_t base, int row0,
                                       int c, int col0) {
  using P = AttnOut<kH>;
  if constexpr (P::kPair)
    if (c * kKC < col0 || c * kKC >= col0 + P::kCols) return;
  mbar_wait(base + P::kBarAEmpty + 8 * c, 0);
  mbar_arrive_expect_tx(base + P::kBarAFull + 8 * c, kBlockBytes);
  tma_load_2d(base + P::kOffA + c * kBlockBytes, x_map, base + P::kBarAFull + 8 * c, c * kKC,
              row0);
}

// The producer thread: per chunk of the slice, ctx's column block and the
// Wo tiles of the block's columns (from col0; consumer 0's and 1's in turn),
// then x's blocks two chunks behind (tiled path only; kWide: x's blocks of
// the block's columns, from the third chunk on).
template <int kH>
__device__ __forceinline__ void produce(const CUtensorMap* ctx_map, const CUtensorMap* x_map,
                                        const CUtensorMap* wo_map, uint32_t base, int row0,
                                        int col0, int c_begin, int n_chunks, bool split) {
  using P = AttnOut<kH>;
  Ring ring[kWG];
  for (int k = 0; k < n_chunks; ++k) {
    const int c = c_begin + k;
    if constexpr (P::kWide) {
      // ctx's column block c into ring slot k % kCtxStages, once both
      // consumers are done with the slot's previous block
      const uint32_t s = k % P::kCtxStages;
      const uint32_t full = base + P::kBarCFull + 8 * s;
      mbar_wait(base + P::kBarCEmpty + 8 * s, ((k / P::kCtxStages) & 1) ^ 1);
      mbar_arrive_expect_tx(full, kBlockBytes);
      tma_load_2d(base + P::kOffC + s * kBlockBytes, ctx_map, full, c * kKC, row0);
    } else {
      mbar_arrive_expect_tx(base + P::kBarAFull + 8 * c, kBlockBytes);
      if constexpr (P::kPair) {  // every other ctx block, into both blocks
        if (c % 2 == col0 / P::kCols)
          mrd::tma_load_2d_multicast(base + P::kOffA + c * kBlockBytes, ctx_map,
                                     base + P::kBarAFull + 8 * c, c * kKC, row0, 0x3);
      } else {
        tma_load_2d(base + P::kOffA + c * kBlockBytes, ctx_map, base + P::kBarAFull + 8 * c,
                    c * kKC, row0);
      }
    }
#pragma unroll
    for (int j = 0; j < P::kTiles; ++j)
#pragma unroll
      for (int wg = 0; wg < kWG; ++wg) {
        const uint32_t s = wg * P::kStages + ring[wg].slot;
        mbar_wait(base + P::kBarWEmpty + 8 * s, ring[wg].phase ^ 1);
        const uint32_t full = base + P::kBarWFull + 8 * s;
        const uint32_t dst = base + P::kOffW + s * P::kTileBytes;
        const int n0 = col0 + P::kHalf * wg + P::kN * j;
        mbar_arrive_expect_tx(full, P::kTileBytes);
        tma_load_2d(dst, wo_map, full, c * kKC, n0);
        ring[wg].next<P::kStages>();
      }
    if constexpr (P::kWide) {
      // x's block b of the block's columns into its own space, two chunks
      // in (the tiled path runs all 2 kOwn chunks)
      const int b = k - kXLag;
      if (!split && b >= 0 && b < P::kOwn) {
        mbar_arrive_expect_tx(base + P::kBarAFull + 8 * b, kBlockBytes);
        tma_load_2d(base + P::kOffA + b * kBlockBytes, x_map, base + P::kBarAFull + 8 * b,
                    col0 + b * kKC, row0);
      }
    } else {
      if (!split && k >= kXLag) load_x<kH>(x_map, base, row0, c - kXLag, col0);
    }
  }
  if constexpr (!P::kWide)
    if (!split)
      for (int k = n_chunks - kXLag; k < n_chunks; ++k)
        load_x<kH>(x_map, base, row0, c_begin + k, col0);
}

// Consumer wg's share of k chunk c: ACC[:, kHalf wg + 128 j ..] += ctx[:, chunk]
// . Wo^T[chunk, ...] for j < kTiles. After each group is issued, the
// previous one is retired and its slot released (and, at j = 0, the
// previous chunk's ctx block). kFirst: the slice's first chunk, whose first
// step writes the accumulators without reading them.
template <int kH, bool kFirst>
__device__ __forceinline__ void consume_chunk(float (&acc)[AttnOut<kH>::kTiles][AttnOut<kH>::kAcc],
                                              Ring& ring,
                                              uint32_t& prev, uint32_t base, int c, int wg,
                                              bool signal) {
  using P = AttnOut<kH>;
  mbar_wait(base + P::kBarAFull + 8 * c, 0);
#pragma unroll
  for (int j = 0; j < P::kTiles; ++j) {
    const uint32_t s = wg * P::kStages + ring.slot;
    mbar_wait(base + P::kBarWFull + 8 * s, ring.phase);
    const uint32_t a0 = opaque(base) + P::kOffA + c * kBlockBytes;
    const uint32_t b0 = opaque(base) + P::kOffW + s * P::kTileBytes;
    mrd::fence_operand(acc[j]);
    mrd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      const uint64_t da = sw128_desc(a0 + kk * 32), db = sw128_desc(b0 + kk * 32);
      if constexpr (P::kN == 64) {  // H = 128, 384, 640: n64 tiles
        if (kFirst && kk == 0)
          mrd::wgmma_m64n64k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n64k16(acc[j], da, db, 1);
      } else if constexpr (P::kN == 112) {  // H = 896: n112 tiles
        if (kFirst && kk == 0)
          mrd::wgmma_m64n112k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n112k16(acc[j], da, db, 1);
      } else if (kFirst && kk == 0) {
        mrd::wgmma_m64n128k16_first(acc[j], da, db);
      } else {
        mrd::wgmma_m64n128k16(acc[j], da, db, 1);
      }
    }
    mrd::wgmma_commit();
    mrd::fence_operand(acc[j]);
    if (!kFirst || j > 0) {
      mrd::wgmma_wait<1>();
      if (signal) {
        mbar_arrive(base + P::kBarWEmpty + 8 * prev);
        if (j == 0) mbar_arrive(base + P::kBarAEmpty + 8 * (c - 1));
      }
    }
    prev = s;
    ring.next<P::kStages>();
  }
}

// consume_chunk for kWide: the ctx block of the slice's k-th chunk is in
// ring slot k % kCtxStages, and the slot of chunk k - 1 goes back once the
// first group of chunk k is issued and the previous one retired.
template <int kH, bool kFirst>
__device__ __forceinline__ void consume_chunk_wide(
    float (&acc)[AttnOut<kH>::kTiles][AttnOut<kH>::kAcc], Ring& ring, uint32_t& prev,
    uint32_t base, int k, int wg, bool signal) {
  using P = AttnOut<kH>;
  const uint32_t cs = k % P::kCtxStages;
  mbar_wait(base + P::kBarCFull + 8 * cs, (k / P::kCtxStages) & 1);
#pragma unroll
  for (int j = 0; j < P::kTiles; ++j) {
    const uint32_t s = wg * P::kStages + ring.slot;
    mbar_wait(base + P::kBarWFull + 8 * s, ring.phase);
    const uint32_t a0 = opaque(base) + P::kOffC + cs * kBlockBytes;
    const uint32_t b0 = opaque(base) + P::kOffW + s * P::kTileBytes;
    mrd::fence_operand(acc[j]);
    mrd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      const uint64_t da = sw128_desc(a0 + kk * 32), db = sw128_desc(b0 + kk * 32);
      if constexpr (P::kN == 64) {  // H = 1,280: n64 tiles
        if (kFirst && kk == 0)
          mrd::wgmma_m64n64k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n64k16(acc[j], da, db, 1);
      } else if constexpr (P::kN == 96) {  // H = 1,152: n96 tiles
        if (kFirst && kk == 0)
          mrd::wgmma_m64n96k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n96k16(acc[j], da, db, 1);
      } else if constexpr (P::kN == 88) {  // H = 1,408: n88 tiles
        if (kFirst && kk == 0)
          mrd::wgmma_m64n88k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n88k16(acc[j], da, db, 1);
      } else if (kFirst && kk == 0) {
        mrd::wgmma_m64n128k16_first(acc[j], da, db);
      } else {
        mrd::wgmma_m64n128k16(acc[j], da, db, 1);
      }
    }
    mrd::wgmma_commit();
    mrd::fence_operand(acc[j]);
    if (!kFirst || j > 0) {
      mrd::wgmma_wait<1>();
      if (signal) {
        mbar_arrive(base + P::kBarWEmpty + 8 * prev);
        if (j == 0) mbar_arrive(base + P::kBarCEmpty + 8 * ((k - 1) % P::kCtxStages));
      }
    }
    prev = s;
    ring.next<P::kStages>();
  }
}

// The shared-memory address of this thread's elements of tile j, n8 block
// nb in the row tile, from the epilogue's eight group bases `xo`. Where a
// consumer's columns fill whole column blocks, xo[k] is group k of its
// first block; at 896 xo[k] is the k-th group from its first column's, so
// the group counted from there, G, lies at xo[G % 8], G / 8 blocks on.
template <int kH>
__device__ __forceinline__ uint32_t tile_at(const uint32_t (&xo)[8], int j, int nb) {
  using P = AttnOut<kH>;
  if constexpr (P::kHalf % kKC != 0) {
    const int g = P::kN / 8 * j + nb;
    return xo[g % 8] + g / 8 * kBlockBytes;
  } else {
    return xo[nb % 8] + (P::kN / kKC * j + nb / 8) * kBlockBytes;
  }
}

// The pair's total of one row's four partials (this block's two consumers'
// in `red`, the peer's in its red at `peer_red`): on the first of a
// thread's two rows, it first says that this block's values are in place
// (an arrival on the peer's barrier `peer_bar`, after the consumers' named
// barrier) and waits for the peer's (`bar`). Both blocks add rank 0's two
// values, then rank 1's, so they share the total bit for bit.
__device__ __forceinline__ float pair_total(const float* red, uint32_t peer_red,
                                            uint32_t peer_bar, uint32_t bar, int rank, int r,
                                            bool first) {
  if (first) {
    mrd::mbar_arrive_remote(peer_bar);
    mrd::mbar_wait_cluster(bar, 0);
  }
  const float own = red[r] + red[kTM + r];
  const float peer = mrd::ld_cluster_f32(peer_red + 4 * r) +
                     mrd::ld_cluster_f32(peer_red + 4 * (kTM + r));
  return rank == 0 ? own + peer : peer + own;
}

// Grid: (row tiles, slices of the kChunks k chunks, column groups; the
// pair: clusters of the two groups). With one slice the block applies LN
// (the pair: over both blocks) and writes y; otherwise it writes its f32
// partial of ctx . Wo^T to `partial` [slices, M, H] and split_reduce
// finishes the rows.
template <int kH>
__global__ void __launch_bounds__(kThreads, 1)
attn_out_ln_kernel(const __grid_constant__ CUtensorMap ctx_map,  // ctx [M, H]
                   const __grid_constant__ CUtensorMap x_map,    // x [M, H] (tiled path)
                   const __grid_constant__ CUtensorMap wo_map,   // Wo [H out, H in]
                   const __grid_constant__ CUtensorMap y_map,    // y [M, H] (tiled path)
                   const bf16* __restrict__ bo,                  // [H]
                   const bf16* __restrict__ gamma,
                   const bf16* __restrict__ beta,
                   float* __restrict__ partial,                  // [slices, M, H]
                   int M, int chunks_per_slice, float eps) {
  using P = AttnOut<kH>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const bool split = gridDim.y > 1;
  const int c_begin = blockIdx.y * chunks_per_slice;
  const int row0 = blockIdx.x * kTM;
  // the pair's rank (its column group: grid z, the cluster's z) and the
  // block's first output column
  const int rank = P::kPair ? static_cast<int>(mrd::cluster_ctarank()) : 0;
  const int col0 = rank * P::kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    if constexpr (P::kWide) {
      for (int b = 0; b < P::kOwn; ++b) mbar_init(base + P::kBarAFull + 8 * b, 1);
      for (int s = 0; s < P::kCtxStages; ++s) {
        mbar_init(base + P::kBarCFull + 8 * s, 1);
        mbar_init(base + P::kBarCEmpty + 8 * s, kConsumerThreads / 32);
      }
    } else {
      for (int c = 0; c < P::kChunks; ++c) {
        mbar_init(base + P::kBarAFull + 8 * c, 1);
        mbar_init(base + P::kBarAEmpty + 8 * c, kConsumerThreads / 32);
      }
    }
    for (int s = 0; s < kWG * P::kStages; ++s) {
      mbar_init(base + P::kBarWFull + 8 * s, 1);
      mbar_init(base + P::kBarWEmpty + 8 * s, 4);  // the consumer's warps
    }
    if constexpr (P::kPair)  // every consumer thread of the peer, per exchange
      for (int s = 0; s < 2; ++s) mbar_init(base + P::kBarStats + 8 * s, kConsumerThreads);
    fence_barrier_init();
  }
  if constexpr (P::kPair)
    mrd::cluster_sync();  // both blocks' barriers are initialized
  else
    __syncthreads();

  if (threadIdx.x / 128 == kWG) {
    // ---- the producer warpgroup: one thread issues every TMA load
    mrd::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads)
      produce<kH>(&ctx_map, &x_map, &wo_map, base, row0, col0, c_begin, chunks_per_slice,
                  split);
    if constexpr (P::kPair) mrd::cluster_sync();  // the peer is done with this block
  } else {
    // ---- consumer wg: ACC[:, col0 + kHalf wg .. + kHalf] = ctx . Wo^T[:, ...]
    mrd::setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const bool signal = lane == 0;  // one arrival per warp
    float acc[P::kTiles][P::kAcc];  // [64, kHalf] f32: n128 (n64) tiles
    Ring ring;
    uint32_t prev = 0;  // the slot of the group in flight
    if constexpr (P::kWide) {
      consume_chunk_wide<kH, true>(acc, ring, prev, base, 0, wg, signal);
      for (int k = 1; k < chunks_per_slice; ++k)
        consume_chunk_wide<kH, false>(acc, ring, prev, base, k, wg, signal);
    } else {
      consume_chunk<kH, true>(acc, ring, prev, base, c_begin, wg, signal);
      for (int k = 1; k < chunks_per_slice; ++k)
        consume_chunk<kH, false>(acc, ring, prev, base, c_begin + k, wg, signal);
    }
    mrd::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < P::kTiles; ++j) mrd::fence_operand(acc[j]);
    if (signal) {
      mbar_arrive(base + P::kBarWEmpty + 8 * prev);
      if constexpr (P::kWide)
        mbar_arrive(base + P::kBarCEmpty + 8 * ((chunks_per_slice - 1) % P::kCtxStages));
      else
        mbar_arrive(base + P::kBarAEmpty + 8 * (c_begin + chunks_per_slice - 1));
    }

    // ---- epilogue. Thread (warp, lane) holds rows wrow and wrow + 8, and
    // per n8 block nb of tile j the columns col0 + kHalf wg + 128 j + 8 nb +
    // 2 (lane % 4) and + 1: acc[j][4 nb + 2 half + e] is (wrow + 8 half,
    // col + e)
    const int wrow = 16 * (warp % 4) + lane / 4;
    if (split) {  // the f32 partial of the valid rows
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long gr = row0 + wrow + 8 * half;
        if (gr < M) {
          float* dst = partial + (static_cast<long long>(blockIdx.y) * M + gr) * kH;
#pragma unroll
          for (int j = 0; j < P::kTiles; ++j)
#pragma unroll
            for (int nb = 0; nb < P::kN / 8; ++nb) {
              const int col = col0 + P::kHalf * wg + P::kN * j + 8 * nb + 2 * (lane % 4);
              *reinterpret_cast<float2*>(dst + col) =
                  make_float2(acc[j][4 * nb + 2 * half], acc[j][4 * nb + 2 * half + 1]);
            }
        }
      }
      if constexpr (P::kPair) mrd::cluster_sync();  // the peer is done with this block
      return;
    }
    {
      constexpr int kHalf = P::kHalf, kTiles = P::kTiles;
      constexpr int kOwnBlocks = kHalf / kKC;  // 6 / 4 column blocks of x / y per consumer
      // 896: the consumers' 224 columns meet inside a column block
      constexpr bool kShared = kHalf % kKC != 0;
      // this consumer's first column block
      const int own0 = P::kPair ? col0 / kKC + kOwnBlocks * wg : kOwnBlocks * wg;
      // the row tile's column blocks and their full barriers, by global
      // column block (kWide: the block holds its own columns' blocks only,
      // from col0, and x is their first phase, not ctx)
      uint32_t xbase = base + P::kOffA, xbar = base + P::kBarAFull;
      if constexpr (P::kWide) {
        xbase -= col0 / kKC * kBlockBytes;
        xbar -= col0 / kKC * 8;
      }
      constexpr uint32_t kXPhase = P::kWide ? 0 : 1;
      // x's column blocks of this consumer's columns have replaced ctx's
      for (int b = 0; b < kOwnBlocks; ++b)
        mbar_wait(xbar + 8 * (own0 + b), kXPhase);
      if constexpr (kShared)  // and the block its columns end in
        mbar_wait(xbar + 8 * (own0 + kOwnBlocks), kXPhase);
      float* red = reinterpret_cast<float*>(smem + P::kOffRed);
      // the pair: the peer's red and the barriers of its two exchanges
      const uint32_t peer_red =
          P::kPair ? mrd::map_to_rank(base + P::kOffRed, rank ^ 1) : 0;
      const uint32_t peer_bar =
          P::kPair ? mrd::map_to_rank(base + P::kBarStats, rank ^ 1) : 0;
      // This thread's x / y elements in the swizzled tile: columns 8 nb + 2
      // (lane % 4) .. + 1 of this consumer's column block (kN / 64) j + nb / 8 lie
      // in the 16-byte group nb % 8 of their row, which the swizzle moves to
      // group (nb % 8) ^ (row % 8). Rows wrow and wrow + 8 share row % 8, so
      // eight bases serve every element, at constant offsets: a block is 8
      // KB, a row 128 bytes (ptxas keeps one address per element live from
      // the x reads to the y writes otherwise, and spills)
      uint32_t xo[8];
      if constexpr (kShared) {
        // from the group of the consumer's first column, s0 of block own0
        const int s0 = kHalf * wg % kKC / 8;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          xo[k] = xbase + (own0 + (s0 + k) / 8) * kBlockBytes + wrow * 128 +
                  ((((s0 + k) % 8) ^ (wrow % 8)) << 4) + (lane % 4) * 4;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          xo[k] = xbase + own0 * kBlockBytes + wrow * 128 +
                  ((k ^ (wrow % 8)) << 4) + (lane % 4) * 4;
      }
      // + bo + x, and the row sums of this consumer's kHalf columns
      float s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int nb = 0; nb < P::kN / 8; ++nb) {
          const int col = col0 + kHalf * wg + P::kN * j + 8 * nb + 2 * (lane % 4);
          const float2 b2 = ld_pair(bo + col);
          const uint32_t at = tile_at<kH>(xo, j, nb);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 x2 = lds_pair(at + half * 8 * 128);
            float& a0 = acc[j][4 * nb + 2 * half];
            float& a1 = acc[j][4 * nb + 2 * half + 1];
            a0 = a0 + b2.x + x2.x;
            a1 = a1 + b2.y + x2.y;
            s[half] += a0 + a1;
          }
        }
      float mu[2], rstd[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
        if (lane % 4 == 0) red[wg * kTM + wrow + 8 * half] = s[half];
      }
      named_bar_sync<kConsumerThreads>(1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wrow + 8 * half;
        mu[half] = (P::kPair ? pair_total(red, peer_red, peer_bar, base + P::kBarStats, rank,
                                          r, half == 0)
                             : red[r] + red[kTM + r]) *
                   (1.0f / kH);
        s[half] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int i = 0; i < P::kAcc; ++i) {
          const float d = acc[j][i] - mu[(i / 2) % 2];
          s[(i / 2) % 2] += d * d;
        }
      float* red_q = red + kWG * kTM;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
        if (lane % 4 == 0) red_q[wg * kTM + wrow + 8 * half] = s[half];
      }
      named_bar_sync<kConsumerThreads>(1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wrow + 8 * half;
        rstd[half] = rsqrtf((P::kPair ? pair_total(red_q, peer_red + 4 * kWG * kTM, peer_bar + 8,
                                                   base + P::kBarStats + 8, rank, r, half == 0)
                                      : red_q[r] + red_q[kTM + r]) *
                                (1.0f / kH) +
                            eps);
      }
      // y as bf16 over x (each thread rewrites the elements it read), then
      // this consumer's column blocks go out by TMA
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int nb = 0; nb < P::kN / 8; ++nb) {
          const int col = col0 + kHalf * wg + P::kN * j + 8 * nb + 2 * (lane % 4);
          const float2 g2 = ld_pair(gamma + col);
          const float2 o2 = ld_pair(beta + col);
          const uint32_t at = tile_at<kH>(xo, j, nb);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float a0 = acc[j][4 * nb + 2 * half], a1 = acc[j][4 * nb + 2 * half + 1];
            sts_pair(at + half * 8 * 128,
                     __floats2bfloat162_rn((a0 - mu[half]) * rstd[half] * g2.x + o2.x,
                                           (a1 - mu[half]) * rstd[half] * g2.y + o2.y));
          }
        }
      fence_proxy_async();  // the stores, to TMA
      if constexpr (kShared) {
        // both consumers have written the block they share: one thread
        // stores the block's column blocks
        named_bar_sync<kConsumerThreads>(2);
        if (threadIdx.x == 0) {
          for (int b = col0 / kKC; b < (col0 + P::kCols) / kKC; ++b)
            mrd::tma_store_2d(&y_map, xbase + b * kBlockBytes, b * kKC, row0);
          mrd::tma_store_commit();
          mrd::tma_store_wait();
        }
      } else {
        named_bar_sync<128>(2 + wg);
        if (threadIdx.x % 128 == 0) {
          for (int b = own0; b < own0 + kOwnBlocks; ++b)
            mrd::tma_store_2d(&y_map, xbase + b * kBlockBytes, b * kKC, row0);
          mrd::tma_store_commit();
          mrd::tma_store_wait();
        }
      }
      if constexpr (P::kPair) mrd::cluster_sync();  // the peer is done with this block
    }
  }
}

// ---- the cluster of four: the whole-K path from H = 896 up

// one quarter's row partials of a LayerNorm exchange of the cluster of
// four ([consumer][64] f32), and the bytes a consumer's exchange barrier
// takes: the three peers' partials of its 64 rows
constexpr uint32_t kQuadExBytes = kWG * kTM * 4;
constexpr uint32_t kQuadExRecv = 3 * kTM * 4;

// The shape of the cluster-of-four kernel at hidden width kH: a block owns
// 128 rows (64 a consumer) and a quarter of the output columns (kQ, the
// pair's kHalf), so each Wo tile it takes serves 128 rows. At H = 640 the
// same kernel runs in clusters of two, a block owning half of the columns
// (320, 1,280's quarter). Shared memory:
// x, then y, as [128 rows][32 columns] blocks in the 64-byte swizzle
// layout (kQ is a multiple of 32, not always of 64), the ctx ring ([128
// rows][64] a chunk; 2, 3 or 4 slots, whichever lets the producer run the
// most tiles ahead), the Wo ring (as many tiles as fit, at most 8), the
// LayerNorm exchange and the barriers.
template <int kH>
struct AttnOutQuad {
  static_assert(AttnOut<kH>::kPair || kH == 640, "a width of the cluster forms");
  static constexpr int kSize = kH == 640 ? 2 : 4;      // blocks a cluster
  static constexpr int kRows = 2 * kTM;                 // rows a block: 64 a consumer
  static constexpr int kQ = kH / kSize;                 // output columns a block
  static constexpr int kChunks = kH / kKC;
  // Wo tile width (wgmma N): the pair's, but n160 at 1,280 and 640 (n64
  // steps cost ~100 clk whatever the chains: PERF.md)
  static constexpr int kN = kH == 1280 || kH == 640 ? 160 : AttnOut<kH>::kN;
  static constexpr int kAcc = kN / 2;
  static constexpr int kTiles = kQ / kN;
  static constexpr uint32_t kTileBytes = kN * kKC * 2;
  static constexpr int kXCols = 32;
  static constexpr uint32_t kXBlockBytes = kRows * kXCols * 2;  // 8 KB
  static constexpr int kXBlocks = kQ / kXCols;
  static constexpr uint32_t kCtxBytes = kRows * kKC * 2;        // 16 KB
  // x's blocks load one a chunk (two at 640, whose 10 blocks would
  // otherwise start before its 10 chunks), after the tiles of chunks
  // kXFrom .. + kXBlocks / kXPer - 1 (all of x at once held back the tiles
  // behind it by 3-8k clk); the group before's y store is waited for three
  // chunks earlier
  static constexpr int kXPer = kH == 640 ? 2 : 1;
  static constexpr int kXFrom = kChunks - kXBlocks / kXPer - 1;
  static constexpr int kXFree = kXFrom - 3;
  static constexpr uint32_t kOffX = 0;
  static constexpr uint32_t kOffC = kOffX + kXBlocks * kXBlockBytes;
  // the rings' share of shared memory, and the Wo tiles it leaves beside
  // s ctx slots
  static constexpr uint32_t kRingBytes = 208 * 1024 - kOffC;
  static constexpr int wo_tiles(int s) {
    return (kRingBytes - s * kCtxBytes) / kTileBytes < 8
               ? (kRingBytes - s * kCtxBytes) / kTileBytes
               : 8;
  }
  // tiles the producer may run ahead of the consumers with s ctx slots:
  // s - 1 chunks of ctx, one tile less than the Wo ring
  static constexpr int ahead(int s) {
    return (s - 1) * kTiles < wo_tiles(s) - 1 ? (s - 1) * kTiles : wo_tiles(s) - 1;
  }
  static constexpr int kCtxStages = ahead(4) > ahead(3) && ahead(4) > ahead(2) ? 4
                                    : ahead(3) > ahead(2)                     ? 3
                                                                              : 2;
  static constexpr int kStages = wo_tiles(kCtxStages);
  static constexpr uint32_t kOffW = kOffC + kCtxStages * kCtxBytes;
  // the LayerNorm exchange, f32 [buffer][sums, centred squares][quarter
  // from][consumer][64 rows], which the peers' st.async stores fill
  static constexpr uint32_t kOffRed = kOffW + kStages * kTileBytes;
  // ctx and Wo slots: full (TMA bytes) and empty (every consumer warp); x:
  // full (TMA bytes) and empty (each consumer's y store); the exchange:
  // [buffer][sums, centred squares][consumer], each armed by its consumer
  // for the three peers' bytes
  static constexpr uint32_t kBarCFull = kOffRed + 2 * 2 * 4 * kQuadExBytes;
  static constexpr uint32_t kBarCEmpty = kBarCFull + 8 * kCtxStages;
  static constexpr uint32_t kBarWFull = kBarCEmpty + 8 * kCtxStages;
  static constexpr uint32_t kBarWEmpty = kBarWFull + 8 * kStages;
  static constexpr uint32_t kBarXFull = kBarWEmpty + 8 * kStages;
  static constexpr uint32_t kBarXEmpty = kBarXFull + 8;
  static constexpr uint32_t kBarStats = kBarXEmpty + 8;
  static constexpr uint32_t kSmemBytes = kBarStats + 8 * 2 * 2 * kWG + 1024;
  // the bytes a consumer's exchange barrier takes: the peers' partials of
  // its 64 rows
  static constexpr uint32_t kExRecv = (kSize - 1) * kTM * 4;

  // a group's time, in percent of a pair's 64-row tile, for launch's
  // choice between the two forms: K3's time at M = 16,384 (5 rounds)
  // against the pair's (3.88 waves) on the H100 (PERF.md), rounded
  // up at 896, where a third round at 8,448 rows only ties the pair
  static constexpr int kGroupCost = kH == 896    ? 68
                                    : kH == 1024 ? 71
                                    : kH == 1152 ? 60
                                    : kH == 1280 ? 47
                                    : kH == 1408 ? 56
                                                 : 73;

  static_assert(kQ % kN == 0 && kQ % kXCols == 0 && kXBlocks % kXPer == 0,
                "whole tiles and x blocks a block");
  static_assert(kXFrom - 3 >= 1, "the group before's y store waited for in a later chunk");
  static_assert(kOffC % 1024 == 0 && kOffW % 1024 == 0 && kTileBytes % 1024 == 0,
                "1024-byte swizzle atoms");
  static_assert(kStages > kTiles, "a Wo ring deeper than one chunk");
  static_assert(kSmemBytes <= 232448, "over the per-block shared memory");
};

// A row-major bf16 [rows, cols] matrix in boxes of [box_rows, 32] in the
// 64-byte swizzle layout (the cluster of four's x and y).
bool make_map_sw64(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  return make_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows, cols, 32, box_rows,
                     CU_TENSOR_MAP_SWIZZLE_64B);
}

// The producer thread of the cluster of four: for each row group of the
// block (every gridDim.x-th from blockIdx.x), per chunk ctx's [128 rows][64]
// block and the Wo tiles of the block's quarter, and from chunk kXFrom on
// one of x's blocks of the quarter, once the group before has stored its y.
template <int kH>
__device__ __forceinline__ void produce_quad(const CUtensorMap* ctx_map, const CUtensorMap* x_map,
                                             const CUtensorMap* wo_map, uint32_t base, int q,
                                             int n_groups) {
  using Q = AttnOutQuad<kH>;
  Ring cr, wr;
  int it = 0;
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x, ++it) {
    const int row0 = g * Q::kRows;
    for (int k = 0; k < Q::kChunks; ++k) {
      const uint32_t cfull = base + Q::kBarCFull + 8 * cr.slot;
      mbar_wait(base + Q::kBarCEmpty + 8 * cr.slot, cr.phase ^ 1);
      mbar_arrive_expect_tx(cfull, Q::kCtxBytes);
      tma_load_2d(base + Q::kOffC + cr.slot * Q::kCtxBytes, ctx_map, cfull, k * kKC, row0);
      cr.next<Q::kCtxStages>();
#pragma unroll
      for (int j = 0; j < Q::kTiles; ++j) {
        const uint32_t wfull = base + Q::kBarWFull + 8 * wr.slot;
        mbar_wait(base + Q::kBarWEmpty + 8 * wr.slot, wr.phase ^ 1);
        mbar_arrive_expect_tx(wfull, Q::kTileBytes);
        tma_load_2d(base + Q::kOffW + wr.slot * Q::kTileBytes, wo_map, wfull, k * kKC,
                    q * Q::kQ + Q::kN * j);
        wr.next<Q::kStages>();
      }
      if constexpr (Q::kXPer == 1) {
      const int b = k - Q::kXFrom;  // x's block of this chunk
      if (b == 0) {
        if (it > 0) mbar_wait(base + Q::kBarXEmpty, (it - 1) & 1);
        mbar_arrive_expect_tx(base + Q::kBarXFull, Q::kXBlocks * Q::kXBlockBytes);
      }
      if (b >= 0 && b < Q::kXBlocks)
        tma_load_2d(base + Q::kOffX + b * Q::kXBlockBytes, x_map, base + Q::kBarXFull,
                    q * Q::kQ + b * Q::kXCols, row0);
      } else {  // kXPer of x's blocks a chunk
        const int b = (k - Q::kXFrom) * Q::kXPer;
        if (b == 0) {
          if (it > 0) mbar_wait(base + Q::kBarXEmpty, (it - 1) & 1);
          mbar_arrive_expect_tx(base + Q::kBarXFull, Q::kXBlocks * Q::kXBlockBytes);
        }
        if (b >= 0 && b < Q::kXBlocks)
#pragma unroll
          for (int i = 0; i < Q::kXPer; ++i)
            tma_load_2d(base + Q::kOffX + (b + i) * Q::kXBlockBytes, x_map,
                        base + Q::kBarXFull, q * Q::kQ + (b + i) * Q::kXCols, row0);
      }
    }
  }
}

// Consumer wg's share of one chunk of the cluster of four: ACC[64 rows of
// wg, the block's kQ columns] += ctx[rows, chunk] . Wo^T[chunk, columns],
// kTiles wgmma groups on the chunk's ctx slot (this consumer's 64 rows) and
// the Wo tiles in turn. After each group is issued the one before is
// retired and its Wo slot released, and at the first group the previous
// chunk's ctx slot. kFirst: a group's first chunk, whose first step writes
// the accumulators without reading them. (A ring's previous slot is the
// one before its current: nothing else is kept across chunks.)
template <int kH, bool kFirst>
__device__ __forceinline__ void consume_quad(
    float (&acc)[AttnOutQuad<kH>::kTiles][AttnOutQuad<kH>::kAcc], Ring& cr, Ring& wr,
    uint32_t base, int wg, bool signal) {
  using Q = AttnOutQuad<kH>;
  mbar_wait(base + Q::kBarCFull + 8 * cr.slot, cr.phase);
  const uint32_t a0 = opaque(base) + Q::kOffC + cr.slot * Q::kCtxBytes + wg * kBlockBytes;
#pragma unroll
  for (int j = 0; j < Q::kTiles; ++j) {
    mbar_wait(base + Q::kBarWFull + 8 * wr.slot, wr.phase);
    const uint32_t b0 = opaque(base) + Q::kOffW + wr.slot * Q::kTileBytes;
    mrd::fence_operand(acc[j]);
    mrd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      const uint64_t da = sw128_desc(a0 + kk * 32), db = sw128_desc(b0 + kk * 32);
      if constexpr (Q::kN == 160) {  // H = 1,280
        if (kFirst && kk == 0)
          mrd::wgmma_m64n160k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n160k16(acc[j], da, db, 1);
      } else if constexpr (Q::kN == 112) {  // H = 896
        if (kFirst && kk == 0)
          mrd::wgmma_m64n112k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n112k16(acc[j], da, db, 1);
      } else if constexpr (Q::kN == 96) {  // H = 1,152
        if (kFirst && kk == 0)
          mrd::wgmma_m64n96k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n96k16(acc[j], da, db, 1);
      } else if constexpr (Q::kN == 88) {  // H = 1,408
        if (kFirst && kk == 0)
          mrd::wgmma_m64n88k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n88k16(acc[j], da, db, 1);
      } else if (kFirst && kk == 0) {  // H = 1,024, 1,536
        mrd::wgmma_m64n128k16_first(acc[j], da, db);
      } else {
        mrd::wgmma_m64n128k16(acc[j], da, db, 1);
      }
    }
    mrd::wgmma_commit();
    mrd::fence_operand(acc[j]);
    if (!kFirst || j > 0) {
      mrd::wgmma_wait<1>();
      if (signal) {
        mbar_arrive(base + Q::kBarWEmpty + 8 * (wr.slot == 0 ? Q::kStages - 1 : wr.slot - 1));
        if (j == 0)
          mbar_arrive(base + Q::kBarCEmpty +
                      8 * (cr.slot == 0 ? Q::kCtxStages - 1 : cr.slot - 1));
      }
    }
    wr.next<Q::kStages>();
  }
  cr.next<Q::kCtxStages>();
}

// A row's total over the cluster's kSize blocks (four quarters, or at 640
// two halves) for one LayerNorm
// exchange, for the thread's two rows (wrow, wrow + 8; `s` its quarter's
// partials, the same in the four lanes of a row). `red` is this block's
// exchange for the consumer's rows, [quarter from][64], and `bar` its
// barrier, armed for the peers' bytes: the writers (lane % 4 == 0)
// store theirs into each peer's `red` by st.async, counted on the peer's
// barrier, and once this block's has every peer's, each thread reads its
// rows'. The barrier is armed again for its next use (two groups on).
// Every block adds (quarter 0 + quarter 1) + (quarter 2 + quarter 3), the
// pair's order (rank 0's two consumers, then rank 1's), so they share the
// total bit for bit; at 640, half 0 + half 1, the one-block form's order
// (its consumer 0's columns, then consumer 1's).
template <int kSize>
__device__ __forceinline__ void quad_total(float (&s)[2], uint32_t red, uint32_t bar,
                                           uint32_t parity, int q, int lane, int wrow,
                                           bool rearm, bool arms) {
  const uint32_t mine = red + q * kQuadExBytes + 4 * wrow;
  if (lane % 4 == 0) {
#pragma unroll
    for (int p = 1; p < kSize; ++p) {
      const uint32_t peer = (q + p) % kSize;
      const uint32_t at = mrd::map_to_rank(mine, peer), peer_bar = mrd::map_to_rank(bar, peer);
      mrd::st_async_f32(at, s[0], peer_bar);
      mrd::st_async_f32(at + 8 * 4, s[1], peer_bar);
    }
  }
  mrd::mbar_wait_cluster(bar, parity);
  if (rearm && arms) mbar_arrive_expect_tx(bar, (kSize - 1) * kTM * 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float v[kSize];
#pragma unroll
    for (int p = 0; p < kSize; ++p)
      v[p] = p == q ? s[half]
                    : mrd::ld_shared_f32(red + p * kQuadExBytes +
                                         4 * (wrow + 8 * half));
    if constexpr (kSize == 4)
      s[half] = (v[0] + v[1]) + (v[2] + v[3]);
    else
      s[half] = v[0] + v[1];
  }
}

// Grid: (clusters, 1, 4), clusters of the four column quarters (grid z);
// each cluster walks the row groups of 128 rows from blockIdx.x in steps
// of gridDim.x. Per group each block runs the whole k loop for its
// quarter, adds bo and x, takes the LayerNorm's row statistics over the
// cluster and stores y.
template <int kH>
__global__ void __launch_bounds__(kThreads, 1)
attn_out_quad_kernel(const __grid_constant__ CUtensorMap ctx_map,  // ctx [M, H], [128][64] boxes
                     const __grid_constant__ CUtensorMap x_map,    // x [M, H], [128][32] boxes
                     const __grid_constant__ CUtensorMap wo_map,   // Wo [H out, H in]
                     const __grid_constant__ CUtensorMap y_map,    // y [M, H], [64][32] boxes
                     const bf16* __restrict__ bo,                  // [H]
                     const bf16* __restrict__ gamma,
                     const bf16* __restrict__ beta,
                     int M, float eps) {
  using Q = AttnOutQuad<kH>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int q = static_cast<int>(mrd::cluster_ctarank());  // the block's quarter (grid z)
  const int n_groups = (M + Q::kRows - 1) / Q::kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Q::kCtxStages; ++s) {
      mbar_init(base + Q::kBarCFull + 8 * s, 1);
      mbar_init(base + Q::kBarCEmpty + 8 * s, kConsumerThreads / 32);
    }
    for (int s = 0; s < Q::kStages; ++s) {
      mbar_init(base + Q::kBarWFull + 8 * s, 1);
      mbar_init(base + Q::kBarWEmpty + 8 * s, kConsumerThreads / 32);
    }
    mbar_init(base + Q::kBarXFull, 1);
    mbar_init(base + Q::kBarXEmpty, kWG);
    // the exchange barriers, armed for the first two groups
    for (int s = 0; s < 2 * 2 * kWG; ++s) {
      mbar_init(base + Q::kBarStats + 8 * s, 1);
      mbar_arrive_expect_tx(base + Q::kBarStats + 8 * s, Q::kExRecv);
    }
    fence_barrier_init();
  }
  mrd::cluster_sync();  // every block's barriers are initialized

  if (threadIdx.x / 128 == kWG) {
    // ---- the producer warpgroup: one thread issues every TMA load
    mrd::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads)
      produce_quad<kH>(&ctx_map, &x_map, &wo_map, base, q, n_groups);
  } else {
    // ---- consumer wg: rows 64 wg .. + 64 of each group, the block's quarter
    mrd::setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const bool signal = lane == 0;  // one arrival per warp
    float acc[Q::kTiles][Q::kAcc];
    Ring cr, wr;
    for (int it = 0;; ++it) {
      const int g = blockIdx.x + it * gridDim.x;
      if (g >= n_groups) break;
      consume_quad<kH, true>(acc, cr, wr, base, wg, signal);
      for (int k = 1; k < Q::kChunks; ++k) {
        consume_quad<kH, false>(acc, cr, wr, base, wg, signal);
        if (k == Q::kXFree && it > 0 && threadIdx.x % 128 == 0) {
          // the group before's y has left x's space
          mrd::tma_store_wait();
          mbar_arrive(base + Q::kBarXEmpty);
        }
      }
      mrd::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < Q::kTiles; ++j) mrd::fence_operand(acc[j]);
      if (signal) {  // the group's last Wo and ctx slots
        mbar_arrive(base + Q::kBarWEmpty + 8 * (wr.slot == 0 ? Q::kStages - 1 : wr.slot - 1));
        mbar_arrive(base + Q::kBarCEmpty + 8 * (cr.slot == 0 ? Q::kCtxStages - 1 : cr.slot - 1));
      }

      // ---- epilogue: + bo + x, the LayerNorm over the cluster, y.
      // Thread (warp, lane) holds rows wrow and wrow + 8 of the consumer's
      // 64 and, per n8 block nb of tile j, the quarter's columns kN j + 8 nb
      // + 2 (lane % 4) and + 1: acc[j][4 nb + 2 half + e] is (wrow + 8 half,
      // col + e). In x's blocks the 16-byte group G = kN / 8 j + nb of its
      // row lies at group G % 4 of block G / 4, which the swizzle moves to
      // (G % 4) ^ ((row / 2) % 4): rows wrow and wrow + 8 (and both
      // consumers' rows) share it, so four bases serve every element at
      // constant offsets.
      const int wrow = 16 * (warp % 4) + lane / 4;
      uint32_t xo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xo[i] = base + Q::kOffX + (wg * kTM + wrow) * 64 + ((i ^ ((wrow >> 1) & 3)) << 4) +
                (lane % 4) * 4;
      mbar_wait(base + Q::kBarXFull, it & 1);
      // this group's exchange buffer and barriers (this consumer's), their
      // phase, and whether they serve the group two on
      const uint32_t buf = it & 1, parity = (it >> 1) & 1;
      const uint32_t bar = base + Q::kBarStats + 8 * (buf * 2 * kWG + wg);
      const uint32_t red_b = base + Q::kOffRed + wg * kTM * 4 + buf * 2 * 4 * kQuadExBytes;
      const bool rearm = g + 2 * static_cast<int>(gridDim.x) < n_groups;
      const bool arms = threadIdx.x % 128 == 0;
      float s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < Q::kTiles; ++j)
#pragma unroll
        for (int nb = 0; nb < Q::kN / 8; ++nb) {
          const int col = q * Q::kQ + Q::kN * j + 8 * nb + 2 * (lane % 4);
          const float2 b2 = ld_pair(bo + col);
          const int G = Q::kN / 8 * j + nb;
          const uint32_t at = xo[G % 4] + G / 4 * Q::kXBlockBytes;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 x2 = lds_pair(at + half * 8 * 64);
            float& a0 = acc[j][4 * nb + 2 * half];
            float& a1 = acc[j][4 * nb + 2 * half + 1];
            a0 = a0 + b2.x + x2.x;
            a1 = a1 + b2.y + x2.y;
            s[half] += a0 + a1;
          }
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
      }
      quad_total<Q::kSize>(s, red_b, bar, parity, q, lane, wrow, rearm, arms);
      float mu[2], rstd[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mu[half] = s[half] * (1.0f / kH);
        s[half] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < Q::kTiles; ++j)
#pragma unroll
        for (int i = 0; i < Q::kAcc; ++i) {
          const float d = acc[j][i] - mu[(i / 2) % 2];
          s[(i / 2) % 2] += d * d;
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
      }
      quad_total<Q::kSize>(s, red_b + 4 * kQuadExBytes, bar + 8 * kWG, parity, q, lane, wrow,
                           rearm, arms);
#pragma unroll
      for (int half = 0; half < 2; ++half) rstd[half] = rsqrtf(s[half] * (1.0f / kH) + eps);
      // y as bf16 over x (each thread rewrites the elements it read), then
      // this consumer's 64 rows go out by TMA; x's space is released once
      // they have been read, a few chunks into the next group
#pragma unroll
      for (int j = 0; j < Q::kTiles; ++j)
#pragma unroll
        for (int nb = 0; nb < Q::kN / 8; ++nb) {
          const int col = q * Q::kQ + Q::kN * j + 8 * nb + 2 * (lane % 4);
          const float2 g2 = ld_pair(gamma + col);
          const float2 o2 = ld_pair(beta + col);
          const int G = Q::kN / 8 * j + nb;
          const uint32_t at = xo[G % 4] + G / 4 * Q::kXBlockBytes;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float a0 = acc[j][4 * nb + 2 * half], a1 = acc[j][4 * nb + 2 * half + 1];
            sts_pair_free(at + half * 8 * 64,
                          __floats2bfloat162_rn((a0 - mu[half]) * rstd[half] * g2.x + o2.x,
                                                (a1 - mu[half]) * rstd[half] * g2.y + o2.y));
          }
        }
      fence_proxy_async();  // the stores, to TMA
      named_bar_sync<128>(2 + wg);
      if (threadIdx.x % 128 == 0) {
        for (int b = 0; b < Q::kXBlocks; ++b)
          mrd::tma_store_2d(&y_map, base + Q::kOffX + b * Q::kXBlockBytes + wg * kTM * 64,
                            q * Q::kQ + b * Q::kXCols, g * Q::kRows + wg * kTM);
        mrd::tma_store_commit();
      }
    }
    if (threadIdx.x % 128 == 0) mrd::tma_store_wait();
  }
  mrd::cluster_sync();  // no peer reads this block's exchange or arrives on its barriers
}

// ---- the tile form at H = 128: several blocks an SM

// The shape of attn_out_tile_kernel at hidden width kH (128): a block owns
// one 64-row tile, as attn_out_ln_kernel's does, with the same two
// consumers, column split and epilogue; but its whole input fits in a
// third of the SM's shared memory, so kBlocks blocks share an SM and one
// tile's LayerNorm and y store run beside the other tiles' loads. One
// thread issues every load at the block's start: ctx's column blocks, x's
// into a space of their own (the one-block form loads x over ctx once the
// product is done, which put its round trip between the product and the
// LayerNorm), and every Wo tile of the product ([chunk][consumer]; 32 KB
// at 128), each chunk's ctx block and Wo tiles on one barrier. No producer
// warpgroup, no ring; y is written over x and stored by TMA.
template <int kH>
struct AttnOutTile {
  using P = AttnOut<kH>;
  static_assert(kH == 128, "the width of the tile form");
  static constexpr int kBlocks = 3;                   // resident blocks an SM
  static constexpr int kThreads = kConsumerThreads;  // the two consumers
  static constexpr uint32_t kOffC = 0;
  static constexpr uint32_t kOffX = kOffC + P::kChunks * kBlockBytes;
  static constexpr uint32_t kOffW = kOffX + P::kChunks * kBlockBytes;
  static constexpr uint32_t kBarC = kOffW + P::kChunks * kWG * P::kTileBytes;
  static constexpr uint32_t kBarX = kBarC + 8 * P::kChunks;
  static constexpr uint32_t kOffRed = kBarX + 8;  // float [2][2][64]
  static constexpr uint32_t kSmemBytes = kOffRed + 2 * kWG * kTM * 4 + 1024;

  static_assert(P::kTiles == 1 && P::kHalf == kKC && !P::kPair,
                "one Wo tile and one column block a consumer");
  static_assert(kBlocks * (kSmemBytes + 1024) <= 233472, "kBlocks blocks an SM");
};

// Grid: one block per 64-row tile. The block computes its tile's y = LN(x
// + ctx . Wo^T + bo) as attn_out_ln_kernel's tiled path does, in the same
// order, so the bits are those of that form's whole k loop.
template <int kH>
__global__ void __launch_bounds__(AttnOutTile<kH>::kThreads, AttnOutTile<kH>::kBlocks)
attn_out_tile_kernel(const __grid_constant__ CUtensorMap ctx_map,  // ctx [M, H]
                     const __grid_constant__ CUtensorMap x_map,    // x [M, H]
                     const __grid_constant__ CUtensorMap wo_map,   // Wo [H out, H in]
                     const __grid_constant__ CUtensorMap y_map,    // y [M, H]
                     const bf16* __restrict__ bo,                  // [H]
                     const bf16* __restrict__ gamma,
                     const bf16* __restrict__ beta,
                     float eps) {
  using T = AttnOutTile<kH>;
  using P = typename T::P;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int row0 = blockIdx.x * kTM;
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int c = 0; c < P::kChunks; ++c) mbar_init(base + T::kBarC + 8 * c, 1);
    mbar_init(base + T::kBarX, 1);
    fence_barrier_init();
    for (int c = 0; c < P::kChunks; ++c) {
      const uint32_t bar = base + T::kBarC + 8 * c;
      mbar_arrive_expect_tx(bar, kBlockBytes + kWG * P::kTileBytes);
      tma_load_2d(base + T::kOffC + c * kBlockBytes, &ctx_map, bar, c * kKC, row0);
      for (int w = 0; w < kWG; ++w)
        tma_load_2d(base + T::kOffW + (c * kWG + w) * P::kTileBytes, &wo_map, bar, c * kKC,
                    P::kHalf * w);
    }
    mbar_arrive_expect_tx(base + T::kBarX, P::kChunks * kBlockBytes);
    for (int c = 0; c < P::kChunks; ++c)
      tma_load_2d(base + T::kOffX + c * kBlockBytes, &x_map, base + T::kBarX, c * kKC, row0);
  }
  __syncthreads();  // the barriers are initialized

  // ---- consumer wg: ACC[:, kHalf wg .. + kHalf] = ctx . Wo^T[:, ...], one
  // wgmma group a chunk
  float acc[P::kTiles][P::kAcc];
#pragma unroll
  for (int c = 0; c < P::kChunks; ++c) {
    mbar_wait(base + T::kBarC + 8 * c, 0);
    const uint32_t a0 = opaque(base) + T::kOffC + c * kBlockBytes;
    const uint32_t b0 = opaque(base) + T::kOffW + (c * kWG + wg) * P::kTileBytes;
    mrd::fence_operand(acc[0]);
    mrd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      const uint64_t da = sw128_desc(a0 + kk * 32), db = sw128_desc(b0 + kk * 32);
      if (c == 0 && kk == 0)
        mrd::wgmma_m64n64k16_first(acc[0], da, db);
      else
        mrd::wgmma_m64n64k16(acc[0], da, db, 1);
    }
    mrd::wgmma_commit();
    mrd::fence_operand(acc[0]);
  }
  mrd::wgmma_wait<0>();
  mrd::fence_operand(acc[0]);

  // ---- epilogue, as attn_out_ln_kernel's: thread (warp, lane) holds rows
  // wrow and wrow + 8 and, per n8 block nb, the columns kHalf wg + 8 nb + 2
  // (lane % 4) and + 1
  const int wrow = 16 * (warp % 4) + lane / 4;
  const uint32_t xbase = base + T::kOffX;
  mbar_wait(base + T::kBarX, 0);
  float* red = reinterpret_cast<float*>(smem + T::kOffRed);
  uint32_t xo[8];  // the eight 16-byte groups of the consumer's block, in rows wrow (+ 8)
#pragma unroll
  for (int k = 0; k < 8; ++k)
    xo[k] = xbase + wg * kBlockBytes + wrow * 128 + ((k ^ (wrow % 8)) << 4) + (lane % 4) * 4;
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nb = 0; nb < P::kN / 8; ++nb) {
    const int col = P::kHalf * wg + 8 * nb + 2 * (lane % 4);
    const float2 b2 = ld_pair(bo + col);
    const uint32_t at = tile_at<kH>(xo, 0, nb);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 x2 = lds_pair(at + half * 8 * 128);
      float& a0 = acc[0][4 * nb + 2 * half];
      float& a1 = acc[0][4 * nb + 2 * half + 1];
      a0 = a0 + b2.x + x2.x;
      a1 = a1 + b2.y + x2.y;
      s[half] += a0 + a1;
    }
  }
  float mu[2], rstd[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
    s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
    if (lane % 4 == 0) red[wg * kTM + wrow + 8 * half] = s[half];
  }
  named_bar_sync<kConsumerThreads>(1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wrow + 8 * half;
    mu[half] = (red[r] + red[kTM + r]) * (1.0f / kH);
    s[half] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < P::kAcc; ++i) {
    const float d = acc[0][i] - mu[(i / 2) % 2];
    s[(i / 2) % 2] += d * d;
  }
  float* red_q = red + kWG * kTM;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
    s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
    if (lane % 4 == 0) red_q[wg * kTM + wrow + 8 * half] = s[half];
  }
  named_bar_sync<kConsumerThreads>(1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wrow + 8 * half;
    rstd[half] = rsqrtf((red_q[r] + red_q[kTM + r]) * (1.0f / kH) + eps);
  }
  // y as bf16 over x, then this consumer's column block goes out by TMA
#pragma unroll
  for (int nb = 0; nb < P::kN / 8; ++nb) {
    const int col = P::kHalf * wg + 8 * nb + 2 * (lane % 4);
    const float2 g2 = ld_pair(gamma + col);
    const float2 o2 = ld_pair(beta + col);
    const uint32_t at = tile_at<kH>(xo, 0, nb);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float a0 = acc[0][4 * nb + 2 * half], a1 = acc[0][4 * nb + 2 * half + 1];
      sts_pair(at + half * 8 * 128,
               __floats2bfloat162_rn((a0 - mu[half]) * rstd[half] * g2.x + o2.x,
                                     (a1 - mu[half]) * rstd[half] * g2.y + o2.y));
    }
  }
  fence_proxy_async();  // the stores, to TMA
  named_bar_sync<128>(2 + wg);
  if (threadIdx.x % 128 == 0) {
    mrd::tma_store_2d(&y_map, xbase + wg * kBlockBytes, wg * kKC, row0);
    mrd::tma_store_commit();
    mrd::tma_store_wait();
  }
}

// A launch of blocks of kThreads with `smem` bytes of shared memory each,
// in clusters of `size` along grid z, on `stream`
void cluster_launch(cudaLaunchConfig_t& config, cudaLaunchAttribute& attr, dim3 grid, int size,
                    uint32_t smem, cudaStream_t stream) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = size;
  config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
}

// Clusters of `size` blocks of `kernel` (`smem` bytes of shared memory a
// block) that the card holds at once, or 0 if the runtime cannot say.
template <typename Kernel>
int resident_clusters(Kernel kernel, int size, uint32_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  cluster_launch(config, attr, dim3(1, 1, size), size, smem, nullptr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &config) == cudaSuccess ? n : 0;
}

// The clusters of four to launch for the whole k loop of M rows at width
// kH, or 0 where the pair is faster: the four's rounds of row groups over
// the resident clusters, each kGroupCost percent of a pair's tile, against
// the pair's waves of 64-row tiles over the resident pairs (30 and 66 on
// the H100; read once). As many as the card holds, at most one per group.
template <int kH>
int quad_clusters(int M) {
  using Q = AttnOutQuad<kH>;
  static const int quads = resident_clusters(attn_out_quad_kernel<kH>, 4, Q::kSmemBytes);
  static const int pairs = resident_clusters(attn_out_ln_kernel<kH>, 2, AttnOut<kH>::kSmemBytes);
  if (quads < 1 || pairs < 1) return 0;
  const int groups = (M + Q::kRows - 1) / Q::kRows;
  const int tiles = (M + kTM - 1) / kTM;
  if ((groups + quads - 1) / quads * Q::kGroupCost >= (tiles + pairs - 1) / pairs * 100) return 0;
  return groups < quads ? groups : quads;
}

// The cluster-of-four kernel at width kH in `clusters` clusters on `stream`.
template <int kH>
cudaError_t launch_quad(const void* ctx, const void* x, const void* wo, const bf16* bo,
                        const bf16* gamma, const bf16* beta, void* y, int M, float eps,
                        int clusters, cudaStream_t stream) {
  using Q = AttnOutQuad<kH>;
  CUtensorMap ctx_map, wo_map, x_map, y_map;
  if (!make_map(&ctx_map, ctx, M, kH, Q::kRows) || !make_map(&wo_map, wo, kH, kH, Q::kN) ||
      !make_map_sw64(&x_map, x, M, kH, Q::kRows) || !make_map_sw64(&y_map, y, M, kH, kTM))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(attn_out_quad_kernel<kH>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(Q::kSmemBytes));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  cluster_launch(config, attr, dim3(clusters, 1, Q::kSize), Q::kSize, Q::kSmemBytes, stream);
  return cudaLaunchKernelEx(&config, attn_out_quad_kernel<kH>, ctx_map, x_map, wo_map, y_map,
                            bo, gamma, beta, M, eps);
}

// The overlapped form at 640 (`slices` 0 in the C entry): clusters of two
// of attn_out_quad_kernel, as many as the card holds at once (66 on the
// H100, read once), at most one per row group.
template <int kH>
cudaError_t launch_overlap(const void* ctx, const void* x, const void* wo, const bf16* bo,
                           const bf16* gamma, const bf16* beta, void* y, int M, float eps,
                           cudaStream_t stream) {
  using Q = AttnOutQuad<kH>;
  static const int clusters = resident_clusters(attn_out_quad_kernel<kH>, Q::kSize, Q::kSmemBytes);
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const int groups = (M + Q::kRows - 1) / Q::kRows;
  const cudaError_t err = launch_quad<kH>(ctx, x, wo, bo, gamma, beta, y, M, eps,
                                          groups < clusters ? groups : clusters, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The tile form at 128, the width's only form: one block per 64-row tile.
template <int kH>
cudaError_t launch_tile(const void* ctx, const void* x, const void* wo, const bf16* bo,
                        const bf16* gamma, const bf16* beta, void* y, int M, float eps,
                        cudaStream_t stream) {
  using T = AttnOutTile<kH>;
  CUtensorMap ctx_map, wo_map, x_map, y_map;
  if (!make_map(&ctx_map, ctx, M, kH, kTM) || !make_map(&wo_map, wo, kH, kH, AttnOut<kH>::kN) ||
      !make_map(&x_map, x, M, kH, kTM) || !make_map(&y_map, y, M, kH, kTM))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_out_tile_kernel<kH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(T::kSmemBytes));
  if (err == cudaSuccess)  // the shared memory of kBlocks blocks an SM
    err = cudaFuncSetAttribute(attn_out_tile_kernel<kH>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  attn_out_tile_kernel<kH><<<(M + kTM - 1) / kTM, T::kThreads, T::kSmemBytes, stream>>>(
      ctx_map, x_map, wo_map, y_map, bo, gamma, beta, eps);
  return cudaGetLastError();
}

template <int kH>
cudaError_t launch(const void* ctx, const void* x, const void* wo, const bf16* bo,
                   const bf16* gamma, const bf16* beta, void* y, void* scratch, int M,
                   int slices, float eps, cudaStream_t stream) {
  using P = AttnOut<kH>;
  const bool split = slices > 1;
  if constexpr (P::kPair) {  // the whole k loop: the cluster of four where it is faster
    const int clusters = split ? 0 : quad_clusters<kH>(M);
    if (clusters > 0) {
      const cudaError_t err =
          launch_quad<kH>(ctx, x, wo, bo, gamma, beta, y, M, eps, clusters, stream);
      return err != cudaSuccess ? err : cudaGetLastError();
    }
  }
  CUtensorMap ctx_map, wo_map, x_map{}, y_map{};  // x and y by TMA on the tiled path only
  if (!make_map(&ctx_map, ctx, M, kH, kTM) ||
      !make_map(&wo_map, wo, kH, kH, P::kN) ||
      (!split && (!make_map(&x_map, x, M, kH, kTM) || !make_map(&y_map, y, M, kH, kTM))))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_out_ln_kernel<kH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(P::kSmemBytes));
  if (err != cudaSuccess) return err;
  auto* part = static_cast<float*>(scratch);
  const dim3 grid((M + kTM - 1) / kTM, slices, P::kGroups);
  if constexpr (P::kPair) {
    // the two column groups of a row tile and slice as one cluster
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t config;
    cluster_launch(config, attr, grid, P::kGroups, P::kSmemBytes, stream);
    err = cudaLaunchKernelEx(&config, attn_out_ln_kernel<kH>, ctx_map, x_map, wo_map, y_map,
                             bo, gamma, beta, part, M, P::kChunks / slices, eps);
    if (err != cudaSuccess) return err;
  } else {
    attn_out_ln_kernel<kH><<<grid, kThreads, P::kSmemBytes, stream>>>(
        ctx_map, x_map, wo_map, y_map, bo, gamma, beta, part, M, P::kChunks / slices, eps);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  split_reduce<kH, bf16, false><<<(M + 7) / 8, 256, 0, stream>>>(
      part, slices, static_cast<const bf16*>(x), bo, gamma, beta, nullptr, nullptr,
      static_cast<bf16*>(y), M, eps);
  return cudaGetLastError();
}

template <int kH>
int attn_out_ln_bf16(const void* ctx, const void* x, const void* wo, const void* bo,
                     const void* gamma, const void* beta, void* y, void* scratch, int M,
                     int slices, float eps, void* stream) {
  using P = AttnOut<kH>;
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const auto v = [](const void* p) { return static_cast<const bf16*>(p); };
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (kH == 128) {  // the tile form, at every M: `slices` 0
    if (slices != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_tile<kH>(ctx, x, wo, v(bo), v(gamma), v(beta), y, M, eps, s));
  } else {
    if constexpr (kH == 640)
      if (slices == 0)  // the overlapped form
        return static_cast<int>(
            launch_overlap<kH>(ctx, x, wo, v(bo), v(gamma), v(beta), y, M, eps, s));
    if (slices < 1 || P::kChunks % slices != 0 || (slices > 1 && scratch == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<kH>(ctx, x, wo, v(bo), v(gamma), v(beta), y, scratch, M,
                                       slices, eps, s));
  }
}

// The shared memory a block of the C entry's kernel takes at width kH: at
// 128 the tile form's.
template <int kH>
constexpr uint32_t smem_bytes() {
  if constexpr (kH == 128)
    return AttnOutTile<kH>::kSmemBytes;
  else
    return AttnOut<kH>::kSmemBytes;
}

}  // namespace

// The C entries of K3 and the shared memory per block at a built width H
// other than 768: `name`_h<H>, as attn_out_ln.cu's mrd_attn_out_smem_bytes
// and mrd_attn_out_ln_bf16 with [M, H] rows, wo [H, H], `slices` a divisor
// of the H / 64 k chunks and scratch f32 [slices, M, H]; at 640 `slices` 0
// asks for the overlapped form, and at 128 it is the only `slices` taken
// (the tile form; attn_out_ln_overlap.cu).
#define MRD_ATTN_OUT_WIDTH(kH)                                                               \
  int mrd_attn_out_smem_bytes_h##kH() {                                                      \
    return static_cast<int>(smem_bytes<kH>());                                               \
  }                                                                                          \
  int mrd_attn_out_ln_bf16_h##kH(const void* ctx, const void* x, const void* wo,             \
                                 const void* bo, const void* gamma, const void* beta,        \
                                 void* y, void* scratch, int M, int slices, float eps,       \
                                 void* stream) {                                             \
    return attn_out_ln_bf16<kH>(ctx, x, wo, bo, gamma, beta, y, scratch, M, slices, eps,     \
                                stream);                                                     \
  }
