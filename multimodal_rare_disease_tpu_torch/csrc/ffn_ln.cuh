// K1 and K2: the post-LN BERT FFN sublayer, written by hand for Hopper
// (sm_90a). One kernel template over the hidden width H (768, BERT-base,
// 1,024, BERT-large, 512, 256 and 128, the compact BERTs, 384, MiniLM, 640
// and 896, and 1,152, 1,280, 1,408 and 1,536; the design below is written
// for 768, and the other widths' changes follow it) and
// `kInputLN`:
//
//   K1 (kInputLN = true):  x = bf16(LN0(z))  z: [M, H] bf16, the unnormalized
//                                               attention residual
//   K2 (kInputLN = false): x = the input rows [M, H] bf16 as they are (the
//                          already-normalized output of K3, attn_out_ln.cu)
//
//   h = bf16(GELU(x . W1 + b1))              W1: [H, F] bf16, f32 accumulator,
//                                               exact-erf GELU in f32
//   y = bf16(LN2(f32(x) + h . W2 + b2))      W2: [F, H] bf16
//
// LayerNorm statistics are two-pass in f32 (eps given, 1e-12 for BERT).
// Biases and LayerNorm parameters are widened to f32 on load. K2 reads them
// as bf16 (a model cast to bf16 passes its own); K1 as f32 or bf16.
//
// Replaces multimodal_rare_disease_tpu/ops/pallas/ffn.py::_ffn_pre_ln_kernel
// (K1, reached through _fused_ffn_pre_ln_impl and fused_ffn_ln(pre_gamma=...))
// and ::_ffn_ln_kernel (K2, through _fused_ffn_ln_impl and fused_ffn_ln
// without pre_gamma). The two differ only in the prologue.
//
// What bounds it on the H100: the operations. One call is 4*M*768*F flops
// (155 GFLOP at M = 16,384 and F = 3072: 0.156 ms at the bf16 tensor-core
// peak) against 60-85 MB of device-memory traffic, and the [M, F]
// intermediate never goes to device memory. What a design has to beat is
// the weight stream and the register file: every block that owns a tile of
// rows reads all of W1 and W2 (9.4 MB) from L2, so the rows per block set
// the L2-to-SM traffic (4.8 GB per call at 32 rows per block, 2.4 GB at
// 64); only wgmma reaches the tensor-core rate; LN2 needs whole
// 768-wide rows, so a 64-row tile keeps a [64, 768] f32 accumulator, three
// quarters of the SM's registers; and few rows leave SMs idle.
//
// Design:
//   - a block owns 64 rows (one wgmma M) and three warpgroups of 128
//     threads: two for stage 2 and one for stage 1. setmaxnreg gives each
//     stage-2 warpgroup 224 registers (its 192 accumulator registers stay
//     pinned; at 208 ptxas swaps one 64-register block through local memory
//     every chunk) and stage 1 the remaining 56;
//   - the weights stream by TMA (cp.async.bulk.tensor, tensor maps passed
//     as __grid_constant__ parameters) into two rings of 128-byte-swizzled
//     shared memory with an mbarrier per slot: W1 tiles [32 f x 128 k] (6
//     slots of 8 KB) for stage 1, W2 tiles [128 h x 64 f] (4 slots of 16 KB)
//     for stage 2. There is no producer warp: thread 0 fills both rings and
//     a slot's consumer refills it once its products are done;
//   - the bf16 x tile [64, 768] (96 KB) stays in shared memory in the same
//     swizzled layout, written by all threads in the prologue (LN0 of z for
//     K1, the rows themselves for K2; zeros past M). It is stage 1's A
//     operand and the epilogue's residual;
//   - stage 1, per F chunk of 64 and in two passes of 32 columns:
//     x . W1[:, cols] with wgmma m64n32k16 (A and B from shared memory),
//     + b1, exact-erf GELU in f32, bf16 into one of two [64, 64] chunk
//     buffers in the swizzled layout, handed to stage 2 by full/empty
//     mbarriers, so stage 1 runs up to two chunks ahead;
//   - stage 2, split by output columns: warpgroup wg accumulates its 384
//     columns of chunk . W2[chunk, :] with wgmma m64n128k16 into a [64, 384]
//     f32 accumulator, one wgmma group in flight;
//   - epilogue from registers: + b2 + x, then LN2 with per-row partial sums
//     exchanged between the two stage-2 warpgroups through shared memory
//     (two-pass), and a bf16 store of the valid rows.
// Split-F path for small M: when the row tiles would fill fewer blocks than
// the card has SMs, the launch adds a grid dimension of S slices of F (S
// chosen by kernels/ffn.py::ffn_plan). Each block then runs its slice's
// chunks only and stores its f32 partial of h . W2 for the valid rows into a
// scratch buffer [S, M, 768]; a second kernel sums the S partials in slice
// order, adds b2 and x (LN0 recomputed for K1, by the same code) and applies
// LN2. No atomics: the result is the same bits on every launch.
// The weights are read in the layout of torch.nn.Linear ([out, in],
// row-major): W1^T [F, H] and W2^T [H, F] are the K-major B operands of the
// two products, which wgmma takes without a transpose.
//
// H = 1,024 (BERT-large, F = 4,096). The design above does not fit twice
// over: a [64, 1,024] f32 accumulator is 256 floats a thread in the two
// stage-2 warpgroups (the limit is 255 registers; the tile is the SM's
// whole register file), and the 128-KB x tile beside the rings is more
// than 227 KB. So a row tile is cut into two column groups of 512 output
// columns, one block each (grid z), run as a cluster of two (a pair) that
// shares the GELU chunks and LN2's row statistics.
// What bounds the pair on the H100 is stage 1, not the weight stream
// (build/pair_probe.py's floors, PERF.md section 6): with the design before
// this one the W1 + W2 stream alone took 42-46% of the kernel's time, at
// 6.9-7.9 TB/s from L2, and stage 1 alone 85-92%. A wgmma m64n32k16 step
// costs ~64-120 clk whatever the number of independent accumulators (16 at
// the tensor-core rate), and a thread that stored into the peer's shared
// memory waits ~1,100-1,300 clk for the stores to land at its next release
// (the cluster proxy fence and the arrival on the peer's barrier), once or
// twice a chunk. A cluster of four that would multicast each weight tile
// to two row tiles halves a stream that does not bind, and the H100 holds
// 30 such clusters (120 SMs) against 66 pairs. So (kAlt, at 896 and
// 1,024):
//   - the pair's blocks take turns at whole GELU chunks: block r computes
//     chunks r, r + 2, ... of the slice over all of H (each block builds
//     the whole x tile, LN0 for K1) with wgmma m64n64k16 on W1 tiles of
//     [64 f x 64 k] (8 KB, 4 slots), half the steps of two m64n32 passes
//     for the same products, in 2 chains of independent accumulators;
//   - + b1, exact-erf GELU, bf16 into chunk buffer r of its own shared
//     memory; each thread's stores go to its own stage 2 as an arrival,
//     and to the peer as one bulk copy of the 8-KB buffer (cp.async.bulk
//     shared::cta to shared::cluster) that no thread waits for: the peer's
//     full barrier expects its bytes (one arrival of its stage 2, each
//     round). A buffer's empty barrier takes the releases of both blocks'
//     stage-2 warpgroups (4);
//   - each stage-2 warpgroup waits for its own W2 tiles only: chunks that
//     arrive from the peer can set one warpgroup a ring slot's round ahead
//     of the other's wait, which the old all-tiles wait read as the wrong
//     round (this design's first card run deadlocked on it);
//   - the registers: stage 2 keeps 184 (its 128 accumulator floats), stage
//     1 the 136 left; W2 streams as [64 h x 64 f] tiles (4 slots of 8 KB):
//     x 128 KB + chunks 16 + W1 ring 32 + W2 ring 32 = 208 KB;
//   - LN2 over the pair: each stage-2 warpgroup adds b2 and x (the whole x
//     tile is in each block) to its [64, 256], and the row sums of its
//     columns go into both blocks' exchange (the W1 ring's slots, idle by
//     then) with an arrival on the peer's barrier; each block adds the four
//     partials of a row in one order, so both get the same mean, and the
//     centred sums of squares go the same way; then each block writes y
//     for its 512 columns. With F split (small M), each block stores its
//     f32 partial instead and split_reduce finishes the rows, as above;
//   - a cluster barrier after the barriers' initialization (before any
//     remote access) and before exit (no block leaves while its peer may
//     still write to it).
// Stage 1 still paces the pair: a turn of two chunks takes ~8,500 clk,
// products ~4,700 of it and the GELU ~2,500, and stage 2 ~4,400 a chunk
// (pair_probe.py's timeline). PERF.md section 6 has the times against the
// design before (build/pair_old_vs_new.py).
//
// H = 128, 256, 384, 512 and 640 (google-research/bert's BERT-Tiny, -Mini
// and -Medium, microsoft/MiniLM-L12-H384 with F = 1,536, and 640; F = 4H
// otherwise), the one-block widths below 768 (kNarrow). One block per row
// tile, as at 768, with stage-2 slices of [64, H / 2]; the x tile (16-80
// KB) leaves room for deeper rings. A row of an odd number of 128-column
// blocks is read in kH / 128 8-byte groups per lane (rows.cuh's narrow
// forms). 768's stage 1 (two m64n32k16 passes a chunk, the GELU in the same
// warpgroup, 56 registers) paced these widths at 4,900-8,600 clk a chunk,
// the GELU 2,400-2,800 of it, and the rest of the tile (prologue, rings,
// LN2) was 12-28% of the kernel (build/pair_probe.py's floors and
// timeline, PERF.md section 6). So:
//   - registers: stage 2 keeps its accumulator floats (H / 4: 32 to 160)
//     and what its wgmma, GELU and LN2 need, stage 1 the rest (Ffn::kRegs2
//     / kRegs1: 168 / 168 at 128-384, 192 / 120 at 512, 216 / 72 at 640);
//   - stage 1 (s1_narrow) computes each chunk's products over all of H on
//     wgmma m64n64k16 in one pass of [64 f x 64 k] W1 tiles (s1_pass, 2
//     accumulator chains; 1 at 640, whose 72 registers hold one). Four
//     chains did not help: a step with N <= 64 costs ~100 clk here
//     whatever the chains (32 at the tensor rate), so the fewest, widest
//     instructions win, and stage 2 takes a warpgroup's columns in the
//     fewest W2 tiles (n64 at 128, n128 at 256 and 512, one n192 at 384,
//     two n160 at 640; hopper.cuh's m64n192k16, m64n160k16);
//   - the GELU leaves stage 1's path: stage 1 stores its f32 products in
//     fragment order into a products slot (two; one at 640, for the rings)
//     and goes on to the next chunk, and stage 2 (both warpgroups, every
//     thread one stage-1 thread's pairs) applies b1 and the exact-erf GELU
//     into the chunk buffer before its own products (s2_narrow_gelu). The
//     GELU is bound by the SM's arithmetic, ~1.5 values a clock: ~2,700
//     clk a chunk whoever applies it, as long in the GELU of chunk k + 1
//     between stage 2's tile groups of chunk k as one after the other
//     (tried). Stage 1, which waited for its products slot ~1,100-2,100
//     clk a chunk, applies it to the first Ffn::kS1Gelu columns itself
//     (32 at 128, 16 at 256-512, none at 640), which evens the two stages;
//   - the tile's fixed part is shrunk, not spread: the prologue takes a
//     warp's six rows at once (x_tile_rows: every row's loads first, each
//     step of LN0 on all rows together, the arithmetic of rows.cuh's
//     loaders), where a row at a time waited ~1,100 clk for its loads and
//     butterflies; and at 128-384 (Ffn::kStageY) stage 2 writes y into the
//     x tile and stores whole 128-byte lines (at 512 and 640 that spilled
//     stage 2). Two blocks an SM (at most ~113 KB and 80 registers a
//     thread each), a persistent block (a second x tile) or two row tiles
//     a block (twice the x tile and the accumulators) do not fit beside
//     these rings at 256-640.
// The launch plan, the split-F path and LN2 are 768's. Every variant is
// under `if constexpr`, so the other widths' code is compiled as it was.
//
// H = 896 (F = 4H), the odd multiple of 128 below 1,024 with a pair: a
// block's [64, 448] f32 accumulator would be 224 floats a thread in each
// stage-2 warpgroup, all of the 224 registers it has, so 896 is 1,024's
// cluster pair with 448 output columns per block (x tile 112 KB, W1 ring
// 32 KB, W2 ring 56 KB: 216 KB; stage 2 176 registers, stage 1 152). Its
// stage-2 warpgroups own 224 contiguous columns each, as two W2 tiles of
// 112 on wgmma m64n112k16: four tiles a chunk that alternate between the
// warpgroups, like 1,024's four of 128, where tiles of 64 (3.5 a
// warpgroup) do not divide 224 and tiles of 32 would take 14 barrier waits
// a chunk on a ring of 4-KB slots.
//
// H = 1,152, 1,280, 1,408 and 1,536 (F = 4H; 1,536 is
// microsoft/deberta-v2-xlarge's width), above BERT-large (kWide). 1,024's
// pair does not stretch: each of its blocks keeps the whole x tile, since
// stage 1's A operand spans all of H, and 2 * 64 * H bytes is 192 KB at
// 1,536, which leaves no room for the rings. So each block of the pair
// keeps only x's columns of its own output half (64 * H bytes, 96 KB at
// 1,536; K1's LN0 still reads whole z rows for its statistics, in
// load_x_row_ln0's three passes over the packed row, and writes the
// block's half), and stage 1 splits k instead of the chunk's columns:
//   - per GELU chunk of 64, block r computes the f32 partial x[:, half r]
//     . W1[half r, chunk] of the peer's 32 chunk columns and sends it into
//     the peer's partials slot as st.async stores ([64, 32] f32, two
//     slots; the receiver's full barrier counts the bytes, one arrival of
//     its stage 2 expects them), then the partial of its own 32 columns
//     into its own-partial slot; no thread waits for a store to land;
//   - stage 2 (both warpgroups, idle most of a chunk) adds the two
//     partials (own first: the same bits in both blocks' order), + b1,
//     exact-erf GELU, and writes the block's half of the chunk buffer,
//     which is two [64, 32] halves in the 64-byte swizzle, so that each is
//     contiguous: one bulk copy sends it into the peer's buffer, whose full
//     barrier expects its bytes, and stage 2's wgmma reads the buffer
//     through 64-byte-swizzle descriptors (s2_step). The partials slots go
//     back to stage 1 (own) and the peer (its empty barrier) after the
//     GELU, and a buffer's empty barrier takes the peer's two releases;
//   - stage 1 has 56 registers at 1,408 and 1,536 (stage 2's 224 hold its
//     176 or 192 accumulator floats), and any state beyond the partial and
//     the ring spills there: one accumulator chain, the ring slot and
//     parity taken from the tile index, one copy of the pass for both
//     halves. At 1,152 and 1,280 stage 2 keeps 200, stage 1 104, for 4 and
//     2 chains.
// Stage 2, LN2's exchange, the epilogue (its residual needs only the
// block's own columns of x, which is what the block holds) and the split-F
// path are 1,024's. The stage-2 warpgroups own 288, 320, 352 and 384
// columns, as W2 tiles of 96, 64, 88 and 128 (wgmma m64n96k16, m64n64k16,
// m64n88k16, m64n128k16), and 1,152 and 1,408 read rows in 8-byte groups
// (9 and 11 a lane). Shared memory at 1,536: x 96 KB, GELU chunks 16, W1
// ring 16, partials 16, own partials 16, W2 ring 64: 224 KB. Stage 1's
// two passes still pace the pair at 1,536, ~10,000 of the ~10,700 clk a
// chunk (pair_probe.py's timeline); PERF.md section 6 has the times.
//
// This header holds the kernel and the macro of its C entries; ffn_ln.cu
// instantiates it at 768, 1,024, 512, 256 and 128, ffn_ln_odd.cu at 384,
// 640 and 896, ffn_ln_wide.cu at 1,152 and 1,280 and ffn_ln_wide2.cu at
// 1,408 and 1,536: four sources, which build.py's nvccs compile in
// parallel.

#pragma once

#include <cuda.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "rows.cuh"

namespace {

using mrd::bf16;
using mrd::fence_barrier_init;
using mrd::fence_proxy_async;
using mrd::ld_f32;
using mrd::mbar_arrive;
using mrd::mbar_arrive_expect_tx;
using mrd::mbar_init;
using mrd::mbar_wait;
using mrd::named_bar_sync;
using mrd::opaque;
using mrd::Ring;
using mrd::smem_addr;
using mrd::sw128_desc;
using mrd::sw128_offset;
using mrd::tma_load_2d;
using mrd::warp_sum;

constexpr int kTM = 64;                      // rows per block (wgmma M)
constexpr int kFC = 64;                      // F chunk per loop step
constexpr int kS2 = 2;                       // stage-2 warpgroups (0 and 1)
constexpr int kS1WG = kS2;                   // the stage-1 warpgroup (2)
constexpr int kThreads = 128 * (kS2 + 1);
constexpr int kS2Threads = 128 * kS2;
// registers per thread after setmaxnreg: 2 x 128 x 224 + 128 x 56 =
// 384 x 168, the registers the block is launched with. Stage 2 needs its
// 192 accumulator registers pinned at R24 .. R215 and a few above; with
// fewer, ptxas swaps an accumulator through local memory every chunk
constexpr int kS2Regs = 224;
constexpr int kS1Regs = 56;

// W1 tiles [32 f][kW1K k] (stage 1 takes a chunk as two halves of 32
// columns) and W2 tiles [kW2N h][64 f] (tile u of a chunk goes to stage-2
// WG u % 2), each ring refilled by its consumers
constexpr int kS1N = 32;                     // chunk columns per stage-1 pass
constexpr int kHStages = 2;                  // GELU chunks between the stages
constexpr uint32_t kBlockBytes = kTM * 128;  // [64][64] bf16, 8 KB
constexpr uint32_t kW1BoxBytes = kS1N * 128; // a [32][64] bf16 box, 4 KB

// The shape of the kernel at hidden width kH: 768 as the header sets out,
// 1,024 and 896 in two column groups of 512 and 448 (one block each), 128
// to 640 one block a tile with stage 1 over whole chunks and the GELU
// mostly in stage 2 (kNarrow), and the widths above 1,024 as 1,024's pair
// with x split by output halves (kWide).
template <int kH>
struct Ffn {
  static_assert(kH == 128 || kH == 256 || kH == 384 || kH == 512 || kH == 640 ||
                    kH == 768 || kH == 896 || kH == 1024 || kH == 1152 || kH == 1280 ||
                    kH == 1408 || kH == 1536,
                "a width the kernel is built for");
  static constexpr int kGroups = kH >= 896 ? 2 : 1;    // blocks per row tile
  static constexpr bool kPair = kGroups == 2;          // a cluster sharing h
  static constexpr bool kWide = kH > 1024;             // a pair that splits x and k
  // 896 and 1,024: the pair's blocks take turns at whole GELU chunks
  static constexpr bool kAlt = kPair && !kWide;
  // 128-640: one block a tile, stage 1 over whole chunks, GELU in stage 2
  static constexpr bool kNarrow = !kPair && kH < 768;
  static constexpr int kCols = kH / kGroups;           // output columns per block
  static constexpr int kHalf = kCols / kS2;            // 384 / 256 per stage-2 WG
  static constexpr int kW1K = kPair || kNarrow ? 64 : 128;  // k (= H) columns of a W1 tile
  static constexpr int kW1Boxes = kW1K / 64;           // TMA boxes per W1 tile
  // the columns of x (stage 1's k) a block holds: all of H, or its own half
  static constexpr int kXCols = kWide ? kCols : kH;
  static constexpr int kW1PerHalf = kXCols / kW1K;     // 6 / 16 / 9-12
  // W1 tiles a block loads per chunk: both halves, or (kWide) both halves
  // over its k, or (kAlt, kNarrow) the chunk's 64 columns in one tile over
  // all of H, for the chunks the block takes
  static constexpr int kW1PerChunk = kAlt || kNarrow ? kW1PerHalf : 2 * kW1PerHalf;
  // h rows of a W2 tile (wgmma N): 64 where a warpgroup's columns are an
  // odd multiple of 64, 112 at 896, 96 at 1,152, 88 at 1,408
  static constexpr int kW2N = kH == 896    ? 112
                              : kH == 1024 ? 64
                              : kH == 1152 ? 96
                              : kH == 1408 ? 88
                              : kH == 384  ? 192
                              : kH == 640  ? 160
                                           : (kHalf % 128 != 0 ? 64 : 128);
  static constexpr int kAcc = kW2N / 2;                // accumulator floats per W2 tile
  static constexpr uint32_t kW2Bytes = kW2N * kFC * 2;  // 16 KB (8 KB at 128)
  static constexpr int kW2PerChunk = kCols / kW2N;     // 6 / 4
  // ring slots: kNarrow's hold what a chunk's products need in flight
  // against the TMA's latency from L2, in the shared memory x, the chunk
  // buffers and the products slots leave
  static constexpr int kW1Stages = kPair      ? 4
                                   : !kNarrow  ? 6
                                   : kH == 384 ? 4
                                   : kH == 512 ? 6
                                   : kH == 640 ? 4
                                               : 8;
  static constexpr int kW2Stages = kNarrow && kH == 128 ? 8 : 4;
  // kNarrow: slots of stage 1's f32 products (one at 640, for the rings),
  // and the chunk columns whose GELU stage 1 applies itself (the time its
  // products leave it against stage 2's GELU and products; none at 640)
  static constexpr int kPStages = kH == 640 ? 1 : kHStages;
  static constexpr int kS1Gelu = kH == 128 ? 32 : kH == 640 ? 0 : 16;
  // kNarrow's epilogue writes y into the x tile and stores whole lines
  // from it; at 512 and 640 that spilled stage 2's registers, and y goes
  // out as the other forms' pairs
  static constexpr bool kStageY = kNarrow && kH <= 384;
  // the pairs' stage 1: independent accumulator chains a pass spreads its
  // k16 steps over, and the registers of a stage-2 and the stage-1
  // warpgroup after setmaxnreg (stage 2: its accumulator floats and ~32
  // more; at 1,408 and 1,536 the 56 left to stage 1 hold one chain)
  static constexpr int kChains = kNarrow ? (kH == 640 ? 1 : 2)
                                 : !kPair ? 1
                                 : kAlt   ? 2
                                 : kH == 1152 ? 4
                                 : kH == 1280 ? 2
                                              : 1;
  static constexpr int kRegs2 = kH == 896                              ? 176
                                : kH == 1024                             ? 184
                                : kH == 1152 || kH == 1280               ? 200
                                : kH == 512                              ? 192
                                : kH == 640                              ? 216
                                : kNarrow                                ? 168
                                                                         : kS2Regs;
  static constexpr int kRegs1 = 3 * 168 - 2 * kRegs2;
  // chunk columns a stage-1 product covers (wgmma N), and the W1 tiles: [32
  // f x 128 k] (8 KB), the pairs' and kNarrow's [kS1Cols f x 64 k] (kAlt
  // and kNarrow 8 KB, kWide 4)
  static constexpr int kS1Cols = kAlt || kNarrow ? kFC : kS1N;
  static constexpr uint32_t kW1Bytes =
      kPair || kNarrow ? kS1Cols * 128 : kW1Boxes * kW1BoxBytes;
  // kWide: the stage-1 partials the pair exchanges, a slot per GELU chunk
  // buffer of [64 rows, 32 columns] f32 in fragment order; kNarrow: stage
  // 1's products of a chunk, [64 rows, 64 columns] f32 in fragment order
  static constexpr uint32_t kPBytes = kTM * (kNarrow ? kFC : kS1N) * 4;  // 8 KB (16)

  // shared memory, from a 1024-byte aligned base: the x tile as kXCols /
  // 64 column blocks of [64 rows][64 bf16], the GELU chunks, the W1 ring,
  // (kWide) the partials, the W2 ring, the barriers and (fused LN2 only)
  // the LN2 exchange
  static constexpr uint32_t kOffX = 0;
  static constexpr uint32_t kOffH = kOffX + (kXCols / 64) * kBlockBytes;
  static constexpr uint32_t kOffW1 = kOffH + kHStages * kBlockBytes;
  static constexpr uint32_t kOffP = kOffW1 + kW1Stages * kW1Bytes;
  // kWide: this block's own partial of its columns (stage 1 to stage 2)
  static constexpr uint32_t kOffO =
      kOffP + (kWide ? kHStages * kPBytes : kNarrow ? kPStages * kPBytes : 0);
  static constexpr uint32_t kOffW2 = kOffO + (kWide ? kHStages * kPBytes : 0);
  // the rings' full barriers (TMA bytes) and the GELU chunks' full and
  // empty barriers, 8 bytes each
  static constexpr uint32_t kBarW1Full = kOffW2 + kW2Stages * kW2Bytes;
  static constexpr uint32_t kBarW2Full = kBarW1Full + 8 * kW1Stages;
  static constexpr uint32_t kBarHFull = kBarW2Full + 8 * kW2Stages;
  static constexpr uint32_t kBarHEmpty = kBarHFull + 8 * kHStages;
  // the pair's LN2 exchange: barriers of the peer's row sums and centred
  // squares; the values go into the W1 ring, idle by then (kOffW1: float
  // [2: sums, squares][2 ranks][2 WGs][64 rows])
  static constexpr uint32_t kBarStats = kBarHEmpty + 8 * kHStages;
  // kWide: the partials slots' full (the peer's stores, in the receiver,
  // counted in bytes) and empty (the peer's reads, in the sender) barriers,
  // and the own partial's; kNarrow: the products slots' full barriers (a
  // slot is empty again once its chunk buffer is full: kBarHFull)
  static constexpr uint32_t kBarPFull = kBarStats + (kPair ? 16 : 0);
  static constexpr uint32_t kBarPEmpty = kBarPFull + 8 * kHStages;
  static constexpr uint32_t kBarOFull = kBarPEmpty + 8 * kHStages;
  static constexpr uint32_t kBarOEmpty = kBarOFull + 8 * kHStages;
  static constexpr uint32_t kOffRed =
      kBarPFull + (kWide ? 32 * kHStages : kNarrow ? 8 * kPStages : 0);  // float [2][2][64]
  static constexpr uint32_t kSmemBytes = kOffRed + (kPair ? 0 : 2 * kS2 * kTM * 4) + 1024;
  // arrivals on a GELU chunk's full barrier (every stage-1 thread that
  // writes it, kNarrow every stage-2 thread; kAlt: the peer's chunks arrive
  // as bytes, expected by one arrival, and kWide's buffer takes only the
  // peer's half that way) and empty barrier (every stage-2 warpgroup that
  // reads it: kAlt both blocks', kWide the peer's, whose copy of this
  // block's half it frees)
  static constexpr int kHFullArrivals =
      kNarrow ? kS2Threads + (kS1Gelu > 0 ? 128 : 0) : 128;
  static constexpr int kHEmptyArrivals = kAlt ? 2 * kS2 : kS2;

  static_assert(kCols % (kS2 * kW2N) == 0, "whole W2 tiles per WG");
  static_assert(kW2PerChunk % kS2 == 0, "W2 tiles alternate between stage-2 WGs");
  static_assert(kW2Stages % kS2 == 0, "tile g + kW2Stages has the owner of tile g");
  static_assert(kOffW1 % 1024 == 0 && kOffW2 % 1024 == 0 && kW1Bytes % 1024 == 0 &&
                    kW2Bytes % 1024 == 0,
                "1024-byte swizzle atoms");
  static_assert(kSmemBytes <= 232448, "over the per-block shared memory");
  static_assert(!kPair || kW1Stages * kW1Bytes >= 2 * 2 * kS2 * kTM * 4,
                "room for LN2's exchange in the W1 ring");
  static_assert(kRegs1 >= 24 && kRegs1 % 8 == 0 && kRegs1 <= 168 && kRegs2 >= 168 &&
                    kRegs2 <= 256 && kRegs2 % 8 == 0,
                "setmaxnreg hands over exactly the registers it frees");
  static_assert(4 * kW1PerHalf >= kChains, "every chain starts in a pass");
};

static_assert(2 * 128 * kS2Regs + 128 * kS1Regs == kThreads * 168,
              "setmaxnreg must hand over exactly the registers it frees");

// kWide's K1 prologue: x row `gr` = bf16(LN0(z)) as rows.cuh's load_x_row
// (kH % 256 == 0, uint4 groups of 8) or load_x_row_narrow (uint2 groups of
// 4) give it, by the same arithmetic in the same order, so split_reduce,
// which takes x from those, sees the same bits. It keeps only the packed
// row and converts it again for each of the three passes (sum, centred
// squares, the normalized values): the loaders' f32 copy of a 1,536-wide
// row beside the packed one spilled the kernel's registers.
template <int kH, typename V, typename G>
__device__ __forceinline__ void load_x_row_ln0(const mrd::bf16* __restrict__ z, long long gr,
                                               int M, const V* __restrict__ g0,
                                               const V* __restrict__ o0, float eps, int lane,
                                               G (&out)[kH * 2 / sizeof(G) / 32]) {
  constexpr int kGroups = kH * 2 / sizeof(G) / 32;  // per lane
  constexpr int kPairs = sizeof(G) / 4;            // bf16 pairs per group
  if (gr >= M) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) out[j] = G{};
    return;
  }
  const G* src = reinterpret_cast<const G*>(z + gr * kH);
#pragma unroll
  for (int j = 0; j < kGroups; ++j) out[j] = src[lane + 32 * j];
  // the row again for each pass, not a copy of it held across them
  const auto fresh = [&] {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      uint32_t* w = reinterpret_cast<uint32_t*>(&out[j]);
#pragma unroll
      for (int e = 0; e < kPairs; ++e) asm volatile("" : "+r"(w[e]));
    }
  };
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&out[j]);
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      s += f.x + f.y;
    }
  }
  const float mu = mrd::warp_sum(s) * (1.0f / kH);
  fresh();
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&out[j]);
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      q += (f.x - mu) * (f.x - mu);
      q += (f.y - mu) * (f.y - mu);
    }
  }
  const float rstd = rsqrtf(mrd::warp_sum(q) * (1.0f / kH) + eps);
  fresh();
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out[j]);
    const int c = 2 * kPairs * (lane + 32 * j);
#pragma unroll
    for (int e = 0; e < kPairs; ++e) {
      const int cc = c + 2 * e;
      const float2 f = __bfloat1622float2(p[e]);
      p[e] = __floats2bfloat162_rn(
          (f.x - mu) * rstd * mrd::ld_f32(g0 + cc) + mrd::ld_f32(o0 + cc),
          (f.y - mu) * rstd * mrd::ld_f32(g0 + cc + 1) + mrd::ld_f32(o0 + cc + 1));
    }
  }
}

// columns c and c + 1 (c even) of row r of a swizzled tile, as f32
__device__ __forceinline__ float2 pair_at(const unsigned char* tile, int r, int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      tile + sw128_offset(r, c >> 3, kBlockBytes) + (c & 7) * 2));
}

// Issue W1 tile g of the slice (chunk c_begin + g / kW1PerChunk, half
// (g / kW1PerHalf) % 2, or (kWide) the peer's half and then `rank`'s, or
// (kAlt) the whole of the block's every other chunk, or (kNarrow) the
// whole chunk; k-slice t = g % kW1PerHalf: W1^T[f .. f + kS1Cols, kW1K t ..
// + kW1K], kWide from the block's first column) into its ring slot, one box
// per 64 of k.
template <int kH>
__device__ __forceinline__ void load_w1(const CUtensorMap* map, uint32_t base, int c_begin,
                                        int rank, int g) {
  using P = Ffn<kH>;
  const int t = g % P::kW1PerHalf;
  int f;
  if constexpr (P::kWide)  // the peer's half, then the block's own, one box a tile
    f = (c_begin + g / P::kW1PerChunk) * kFC + kS1N * (rank ^ ((g / P::kW1PerHalf) % 2) ^ 1);
  else if constexpr (P::kAlt)  // the block's chunks c_begin + rank, + 2, ..., whole
    f = (c_begin + 2 * (g / P::kW1PerChunk) + rank) * kFC;
  else if constexpr (P::kNarrow)  // every chunk, whole
    f = (c_begin + g / P::kW1PerChunk) * kFC;
  else
    f = (c_begin + g / P::kW1PerChunk) * kFC + kS1N * ((g / P::kW1PerHalf) % 2);
  const uint32_t slot = g % P::kW1Stages;
  const uint32_t bar = base + P::kBarW1Full + 8 * slot;
  const uint32_t dst = base + P::kOffW1 + slot * P::kW1Bytes;
  mbar_arrive_expect_tx(bar, P::kW1Bytes);
  if constexpr (P::kWide)  // k over the block's own columns of x
    tma_load_2d(dst, map, bar, rank * P::kCols + t * P::kW1K, f);
  else
    tma_load_2d(dst, map, bar, t * P::kW1K, f);
  if constexpr (!P::kPair && !P::kNarrow)
    tma_load_2d(dst + P::kW1Bytes / 2, map, bar, t * P::kW1K + 64, f);
}

// Issue W2 tile g of the slice (chunk c_begin + g / kW2PerChunk, tile u =
// g % kW2PerChunk: W2^T[h0 .. h0 + kW2N, f0 .. f0 + 64], h0 in the block's
// column group from col0) into its ring slot.
template <int kH>
__device__ __forceinline__ void load_w2(const CUtensorMap* map, uint32_t base, int c_begin,
                                        int col0, int g) {
  using P = Ffn<kH>;
  const int u = g % P::kW2PerChunk;
  const uint32_t slot = g % P::kW2Stages;
  const uint32_t bar = base + P::kBarW2Full + 8 * slot;
  mbar_arrive_expect_tx(bar, P::kW2Bytes);
  if constexpr (P::kPair)
    tma_load_2d(base + P::kOffW2 + slot * P::kW2Bytes, map, bar,
                (c_begin + g / P::kW2PerChunk) * kFC,
                col0 + P::kHalf * (u % kS2) + P::kW2N * (u / kS2));
  else
    tma_load_2d(base + P::kOffW2 + slot * P::kW2Bytes, map, bar,
                (c_begin + g / P::kW2PerChunk) * kFC,
                P::kHalf * (u % kS2) + P::kW2N * (u / kS2));
}

// One k16 step of stage 2 on a W2 tile of kN columns (kWide's widths):
// D (+)= A . B, overwriting D on the slice's first step.
template <int kN>
__device__ __forceinline__ void s2_step(float (&d)[kN / 2], uint64_t da, uint64_t db,
                                        bool first) {
  if constexpr (kN == 64) {
    if (first)
      mrd::wgmma_m64n64k16_first(d, da, db);
    else
      mrd::wgmma_m64n64k16(d, da, db, 1);
  } else if constexpr (kN == 88) {
    if (first)
      mrd::wgmma_m64n88k16_first(d, da, db);
    else
      mrd::wgmma_m64n88k16(d, da, db, 1);
  } else if constexpr (kN == 96) {
    if (first)
      mrd::wgmma_m64n96k16_first(d, da, db);
    else
      mrd::wgmma_m64n96k16(d, da, db, 1);
  } else {
    if (first)
      mrd::wgmma_m64n128k16_first(d, da, db);
    else
      mrd::wgmma_m64n128k16(d, da, db, 1);
  }
}

// kWide, the stage-2 warpgroups of block `rank` at chunk k (slice chunk c):
// the block's half of the GELU chunk, h[:, 32 rank .. + 32] = bf16(GELU(
// own partial + the peer's partial + b1)), from the partials stage 1 and
// the peer's stage 1 stored, into the half of chunk buffer hs (64-byte
// swizzled), once the peer is done with the buffer's previous round (and
// so the bulk copy of that round has read the half); then warpgroup 0's
// leader hands the partials slots back and copies the half into the peer's
// buffer (one bulk copy, counted on the peer's full barrier). Thread s
// takes stage-1 fragment elements i = 2 m, 2 m + 1 of stage-1 thread t = s
// % 128, m = 4 (s / 128) .. + 3: the column pairs of rows 16 (t / 32) + (t
// % 32) / 4 (+ 8). The two terms are added in the stage-1 order: own
// partial, then the peer's.
template <int kH, typename V>
__device__ __forceinline__ void s2_gelu(uint32_t base, const V* __restrict__ b1, int c, int k,
                                        int chunks, int rank, int wg, bool leader) {
  using P = Ffn<kH>;
  const int hs = k % kHStages;
  const uint32_t round = (k / kHStages) & 1;
  mbar_wait(base + P::kBarOFull + 8 * hs, round);
  mrd::mbar_wait_cluster(base + P::kBarPFull + 8 * hs, round);
  if (wg == 0 && leader) {
    if (k + kHStages < chunks)  // the peer's partial of chunk k + 2
      mbar_arrive_expect_tx(base + P::kBarPFull + 8 * hs, P::kPBytes);
    // the peer has released the buffer's last round, so the bulk copy that
    // sent this half then has read it (and the peer's half may be written)
    mrd::mbar_wait_cluster(base + P::kBarHEmpty + 8 * hs, round ^ 1);
  }
  // both warpgroups are done with the buffer's last round, and its copy
  named_bar_sync<kS2Threads>(1);
  const int s = threadIdx.x;      // 0 .. 255
  const int t = s % 128, w = t / 32, l = t % 32;
  const uint32_t own = base + P::kOffO + hs * P::kPBytes + 4 * t;
  const uint32_t peer = base + P::kOffP + hs * P::kPBytes + 4 * t;
  const uint32_t half = base + P::kOffH + hs * kBlockBytes + rank * (kBlockBytes / 2);
#pragma unroll 1
  for (int m = 4 * (s / 128); m < 4 * (s / 128) + 4; ++m) {
    const int i = 2 * m;
    const int r = 16 * w + l / 4 + 8 * (m % 2), col = 8 * (m / 2) + 2 * (l % 4);
    const float v0 = mrd::ld_shared_f32(own + 4 * 128 * i) +
                     mrd::ld_shared_f32(peer + 4 * 128 * i) +
                     ld_f32(b1 + c * kFC + kS1N * rank + col);
    const float v1 = mrd::ld_shared_f32(own + 4 * 128 * (i + 1)) +
                     mrd::ld_shared_f32(peer + 4 * 128 * (i + 1)) +
                     ld_f32(b1 + c * kFC + kS1N * rank + col + 1);
    mrd::sts_pair(half + mrd::sw64_offset(r, m / 2) + (col & 7) * 2,
                  __floats2bfloat162_rn(0.5f * v0 * (1.0f + erff(v0 * 0.70710678118654752f)),
                                        0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f))));
  }
  fence_proxy_async();            // the half, to the wgmma and the bulk copy
  named_bar_sync<kS2Threads>(1);  // every thread's half written, partials read
  if (wg == 0 && leader) {
    mbar_arrive(base + P::kBarOEmpty + 8 * hs);
    mrd::mbar_arrive_remote(mrd::map_to_rank(base + P::kBarPEmpty + 8 * hs, rank ^ 1));
    mrd::bulk_copy_to_rank(mrd::map_to_rank(half, rank ^ 1), half, kBlockBytes / 2,
                           mrd::map_to_rank(base + P::kBarHFull + 8 * hs, rank ^ 1));
  }
}

// W1 tiles of a slice of `chunks` chunks that block `rank` loads: kAlt's
// blocks take every other chunk (block 0 the first), the others all.
template <int kH>
__device__ __forceinline__ int w1_tiles(int chunks, int rank) {
  using P = Ffn<kH>;
  if constexpr (P::kAlt)
    return (chunks + 1 - rank) / 2 * P::kW1PerChunk;
  else
    return chunks * P::kW1PerChunk;
}

// A pair's stage 2 takes GELU chunk k (buffer hs): it waits for the
// chunk's block (kAlt: this block's stage 1 for buffer `rank`, the bulk
// copy from the peer for the other) or, kWide, for the peer's half (the
// own half is this stage 2's, s2_gelu); warpgroup 0 then expects the
// peer's next copy into this buffer.
template <int kH>
__device__ __forceinline__ void take_h(uint32_t base, int hs, int k, int chunks, int rank,
                                       int wg, bool leader) {
  using P = Ffn<kH>;
  mrd::mbar_wait_cluster(base + P::kBarHFull + 8 * hs, (k / kHStages) & 1);
  if constexpr (P::kWide) {  // the peer's half of chunk k + 2
    if (wg == 0 && leader && k + kHStages < chunks)
      mbar_arrive_expect_tx(base + P::kBarHFull + 8 * hs, kBlockBytes / 2);
  } else if (hs != rank && wg == 0 && leader && k + kHStages < chunks) {
    mbar_arrive_expect_tx(base + P::kBarHFull + 8 * hs, kBlockBytes);
  }
}

// A pair's stage-2 warpgroup is done with chunk buffer hs: an arrival on
// the empty barrier of the block that writes it (kAlt: the block of rank
// hs; kWide: the peer, whose bulk copy writes its half).
template <int kH>
__device__ __forceinline__ void release_h(uint32_t base, int hs, int rank) {
  using P = Ffn<kH>;
  if (P::kAlt && hs == rank)
    mbar_arrive(base + P::kBarHEmpty + 8 * hs);
  else
    mrd::mbar_arrive_remote(mrd::map_to_rank(base + P::kBarHEmpty + 8 * hs, rank ^ 1));
}

// Stage 2 of chunk k (counted from the slice's first) for warpgroup wg:
// ACC[:, kHalf wg .. + kHalf] += h . W2[chunk, ...], from W2 tiles u = 2 j +
// wg. Both stage-2 WGs of a one-block width wait on every W2 tile, the
// other one's included, so each waits on every round of every slot in
// order and the parity waits are exact. A tile's own WG refills its slot
// with tile g + 4 (same owner) once its products are done; that cannot run
// two rounds ahead of the other WG, whose next tile it has to wait for
// first. The pairs' WGs wait for their own tiles only (see below). kFirst:
// the slice's first chunk, whose first step writes the accumulators
// without reading them.
template <int kH, bool kFirst>
__device__ __forceinline__ void s2_chunk(float (&acc)[Ffn<kH>::kW2PerChunk / kS2][Ffn<kH>::kAcc],
                                         Ring& w2, const CUtensorMap* w2_map, uint32_t base,
                                         int c_begin, int col0, int n_w2, int k, int wg,
                                         bool leader, int rank) {
  using P = Ffn<kH>;
  const int hs = k % kHStages;
  if constexpr (P::kPair)
    take_h<kH>(base, hs, k, n_w2 / P::kW2PerChunk, rank, wg, leader);
  else
    mbar_wait(base + P::kBarHFull + 8 * hs, (k / kHStages) & 1);
  int prev = 0;  // the W2 tile of the group in flight
#pragma unroll
  for (int j = 0; j < P::kW2PerChunk / kS2; ++j) {
    uint32_t mine = 0;
    if constexpr (P::kPair) {
      // the pairs: each warpgroup waits for its own tiles only, every round
      // of the slots of its parity in order, so its waits stay exact however
      // far the other warpgroup runs ahead (a chunk buffer from the peer can
      // reach one warpgroup's wait well before the other's)
#pragma unroll
      for (int o = 0; o < kS2; ++o) {
        if (o == wg) {
          mbar_wait(base + P::kBarW2Full + 8 * w2.slot, w2.phase);
          mine = w2.slot;
        }
        w2.next<P::kW2Stages>();
      }
    } else {
#pragma unroll
      for (int o = 0; o < kS2; ++o) {
        mbar_wait(base + P::kBarW2Full + 8 * w2.slot, w2.phase);
        if (o == wg) mine = w2.slot;
        w2.next<P::kW2Stages>();
      }
    }
    const int g = k * P::kW2PerChunk + kS2 * j + wg;
    const uint32_t a0 = opaque(base) + P::kOffH + hs * kBlockBytes;
    const uint32_t b0 = opaque(base) + P::kOffW2 + mine * P::kW2Bytes;
    mrd::fence_operand(acc[j]);
    mrd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFC / 16; ++kk) {
      if constexpr (P::kWide) {  // the chunk buffer: two 64-byte swizzled halves
        s2_step<P::kW2N>(acc[j],
                         mrd::sw64_desc(a0 + (kk / 2) * (kBlockBytes / 2) + (kk % 2) * 32),
                         sw128_desc(b0 + kk * 32), kFirst && kk == 0);
        continue;
      }
      const uint64_t da = sw128_desc(a0 + kk * 32), db = sw128_desc(b0 + kk * 32);
      if constexpr (P::kW2N == 64) {  // H = 128: n64 tiles
        if (kFirst && kk == 0)
          mrd::wgmma_m64n64k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n64k16(acc[j], da, db, 1);
      } else if constexpr (P::kW2N == 112) {  // H = 896: n112 tiles
        if (kFirst && kk == 0)
          mrd::wgmma_m64n112k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n112k16(acc[j], da, db, 1);
      } else if constexpr (P::kW2N == 96) {  // H = 1,152: n96 tiles
        if (kFirst && kk == 0)
          mrd::wgmma_m64n96k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n96k16(acc[j], da, db, 1);
      } else if constexpr (P::kW2N == 88) {  // H = 1,408: n88 tiles
        if (kFirst && kk == 0)
          mrd::wgmma_m64n88k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n88k16(acc[j], da, db, 1);
      } else if constexpr (P::kW2N == 192) {  // H = 384: a warpgroup's columns in one tile
        if (kFirst && kk == 0)
          mrd::wgmma_m64n192k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n192k16(acc[j], da, db, 1);
      } else if constexpr (P::kW2N == 160) {  // H = 640: n160 tiles
        if (kFirst && kk == 0)
          mrd::wgmma_m64n160k16_first(acc[j], da, db);
        else
          mrd::wgmma_m64n160k16(acc[j], da, db, 1);
      } else if (kFirst && kk == 0) {
        mrd::wgmma_m64n128k16_first(acc[j], da, db);
      } else {
        mrd::wgmma_m64n128k16(acc[j], da, db, 1);
      }
    }
    mrd::wgmma_commit();
    mrd::fence_operand(acc[j]);
    if (j > 0) {
      mrd::wgmma_wait<1>();
      if (leader && prev + P::kW2Stages < n_w2)
        load_w2<kH>(w2_map, base, c_begin, col0, prev + P::kW2Stages);
    }
    prev = g;
  }
  mrd::wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < P::kW2PerChunk / kS2; ++j) mrd::fence_operand(acc[j]);
  if (leader) {
    if (prev + P::kW2Stages < n_w2)
      load_w2<kH>(w2_map, base, c_begin, col0, prev + P::kW2Stages);
    if constexpr (P::kPair)
      release_h<kH>(base, hs, rank);
    else
      mbar_arrive(base + P::kBarHEmpty + 8 * hs);
  }
}

// One pass of a pair's stage 1: P[64, kS1Cols] = x[:, the block's k] .
// W1^T's [kS1Cols f x 64 k] tiles g .. g + kW1PerHalf - 1 of the W1 ring
// (refilled as they are used). A tile is four k16 steps of wgmma
// m64n<kS1Cols>k16, short against the latency of the product each adds
// to, so the pass spreads its steps over kChains accumulators (step s on
// chain s % kChains, issued in turn) and adds them into acc[0] in one
// order at the end: kChains products in flight. One wgmma group (a tile)
// stays in flight while the next tile's wait and issue proceed; a tile's
// slot is refilled once its group is done.
template <int kH>
__device__ __forceinline__ void s1_pass(float (&acc)[Ffn<kH>::kChains][Ffn<kH>::kS1Cols / 2],
                                        int& g, const CUtensorMap* w1_map, uint32_t base,
                                        int c_begin, int rank, int n_w1, bool leader) {
  using P = Ffn<kH>;
  constexpr int kC = P::kChains;
  constexpr int kN = P::kS1Cols / 2;  // accumulator floats a thread
#pragma unroll
  for (int t = 0; t < P::kW1PerHalf; ++t, ++g) {
    // tile g's ring slot and the parity of its round, from g itself (no
    // ring position kept beside it: stage 1 has 56 registers at 1,536)
    const uint32_t slot = g % P::kW1Stages;
    mbar_wait(base + P::kBarW1Full + 8 * slot, (g / P::kW1Stages) & 1);
    const uint32_t a0 = opaque(base) + P::kOffX + t * kBlockBytes;
    const uint32_t b0 = opaque(base) + P::kOffW1 + slot * P::kW1Bytes;
    if (t > 0) {
#pragma unroll
      for (int c = 0; c < kC; ++c) mrd::fence_operand(acc[c]);
    }
    mrd::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int step = 4 * t + kk;
      const uint64_t da = sw128_desc(a0 + kk * 32), db = sw128_desc(b0 + kk * 32);
      if constexpr (P::kS1Cols == 64) {
        if (step < kC)
          mrd::wgmma_m64n64k16_first(acc[step % kC], da, db);
        else
          mrd::wgmma_m64n64k16(acc[step % kC], da, db, 1);
      } else if (step < kC) {
        mrd::wgmma_m64n32k16_first(acc[step % kC], da, db);
      } else {
        mrd::wgmma_m64n32k16(acc[step % kC], da, db, 1);
      }
    }
    mrd::wgmma_commit();
#pragma unroll
    for (int c = 0; c < kC; ++c) mrd::fence_operand(acc[c]);
    if (t > 0) {  // tile t - 1 is done: refill its slot
      mrd::wgmma_wait<1>();
      if (leader && g - 1 + P::kW1Stages < n_w1)
        load_w1<kH>(w1_map, base, c_begin, rank, g - 1 + P::kW1Stages);
    }
  }
  mrd::wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kC; ++c) mrd::fence_operand(acc[c]);
  if (leader && g - 1 + P::kW1Stages < n_w1)  // the pass's last tile
    load_w1<kH>(w1_map, base, c_begin, rank, g - 1 + P::kW1Stages);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if constexpr (kC == 4)
      acc[0][i] = (acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i]);
    else if constexpr (kC == 2)
      acc[0][i] = acc[0][i] + acc[1][i];
  }
}

// Stage 1 of the pair at 896 and 1,024 (kAlt), block `rank`: the blocks
// take turns at the slice's GELU chunks, block r at chunks r, r + 2, ...,
// which go to chunk buffer r (hs = rank). Per chunk: P[64, 64] = x . W1[:,
// chunk] over all of H (s1_pass, wgmma m64n64k16), + b1, exact-erf GELU in
// f32, bf16 into the block's chunk buffer once both blocks' stage 2 has
// released it; the stores go to this block's stage 2 as an arrival of each
// thread, and to the peer's as one bulk copy of the 8-KB buffer into the
// peer's, whose full barrier counts the bytes. No thread waits for a store
// to another block's shared memory to land.
template <int kH, typename V>
__device__ __forceinline__ void s1_alt(const CUtensorMap* w1_map, const V* __restrict__ b1,
                                       uint32_t base, int c_begin, int c_end, int n_w1,
                                       int rank, int warp, int lane, bool leader) {
  using P = Ffn<kH>;
  const int wrow = 16 * (warp % 4) + lane / 4;  // this thread's first row
  const uint32_t hbuf = base + P::kOffH + rank * kBlockBytes;
  int g = 0;  // W1 tiles consumed
  for (int c = c_begin + rank; c < c_end; c += 2) {
    const int k = c - c_begin;
    float acc[P::kChains][32];
    float(&p)[32] = acc[0];
    s1_pass<kH>(acc, g, w1_map, base, c_begin, rank, n_w1, leader);
    mrd::mbar_wait_cluster(base + P::kBarHEmpty + 8 * rank, ((k / kHStages) & 1) ^ 1);
#pragma unroll
    for (int nb = 0; nb < kFC / 8; ++nb) {
      const int col = 8 * nb + 2 * (lane % 4);
      const float bb0 = ld_f32(b1 + c * kFC + col);
      const float bb1 = ld_f32(b1 + c * kFC + col + 1);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = wrow + 8 * hr;
        const float v0 = p[4 * nb + 2 * hr] + bb0;
        const float v1 = p[4 * nb + 2 * hr + 1] + bb1;
        mrd::sts_pair(hbuf + sw128_offset(r, col >> 3, kBlockBytes) + (col & 7) * 2,
                      __floats2bfloat162_rn(
                          0.5f * v0 * (1.0f + erff(v0 * 0.70710678118654752f)),
                          0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f))));
      }
    }
    fence_proxy_async();  // the stores, to the wgmma and the bulk copy
    mbar_arrive(base + P::kBarHFull + 8 * rank);
    named_bar_sync<128>(2);  // every stage-1 thread's stores
    if (leader)
      mrd::bulk_copy_to_rank(mrd::map_to_rank(hbuf, rank ^ 1), hbuf, kBlockBytes,
                             mrd::map_to_rank(base + P::kBarHFull + 8 * rank, rank ^ 1));
  }
  mrd::cluster_sync();  // the peer is done with this block
}

// Stage 1 of the kWide pair, block `rank`: per chunk of the slice, the f32
// partial over the block's own k (its columns of x) of the peer's 32 chunk
// columns, sent into the peer's partials slot as st.async stores (counted
// in bytes on the peer's barrier; no thread waits for them to land), then
// of its own 32, stored into the block's own-partial slot for its stage 2,
// which adds the two and applies b1 and the GELU (s2_gelu). Both go in
// fragment order (element i of thread t at 128 i + t), the same in both
// blocks. This warpgroup has 56 registers at 1,536, 16 of them the partial.
template <int kH>
__device__ __forceinline__ void s1_wide(const CUtensorMap* w1_map, uint32_t base, int c_begin,
                                        int c_end, int n_w1, int rank, bool leader) {
  using P = Ffn<kH>;
  const int tid = threadIdx.x % 128;
  int g = 0;  // W1 tiles consumed
  for (int c = c_begin; c < c_end; ++c) {
    const int k = c - c_begin;
    const int hs = k % kHStages;  // the partials slots
    const uint32_t round = (k / kHStages) & 1;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      // the peer's 32 columns, into its slot once it has read the last
      // round; then this block's, into its own slot once stage 2 has
      float acc[P::kChains][16];
      s1_pass<kH>(acc, g, w1_map, base, c_begin, rank, n_w1, leader);
      if (pass == 0) {
        mrd::mbar_wait_cluster(base + P::kBarPEmpty + 8 * hs, round ^ 1);
        const uint32_t peer_part =
            mrd::map_to_rank(base + P::kOffP + hs * P::kPBytes + 4 * tid, rank ^ 1);
        const uint32_t peer_full = mrd::map_to_rank(base + P::kBarPFull + 8 * hs, rank ^ 1);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          mrd::st_async_f32(peer_part + 4 * 128 * i, acc[0][i], peer_full);
      } else {
        mbar_wait(base + P::kBarOEmpty + 8 * hs, round ^ 1);
        const uint32_t own = base + P::kOffO + hs * P::kPBytes + 4 * tid;
#pragma unroll
        for (int i = 0; i < 16; ++i) mrd::sts_f32(own + 4 * 128 * i, acc[0][i]);
        mbar_arrive(base + P::kBarOFull + 8 * hs);
      }
    }
  }
  mrd::cluster_sync();  // the peer is done with this block
}

// + b1, the exact-erf GELU in f32, bf16: the value a GELU chunk holds
__device__ __forceinline__ __nv_bfloat162 gelu_pair(float v0, float v1) {
  return __floats2bfloat162_rn(0.5f * v0 * (1.0f + erff(v0 * 0.70710678118654752f)),
                               0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f)));
}

// Stage 1 of the one-block widths below 768 (kNarrow): per chunk k of the
// slice, P[64, 64] = x . W1[:, chunk] over all of H (s1_pass: wgmma
// m64n64k16 on [64 f x 64 k] W1 tiles, kChains accumulator chains). Its
// first kS1Gelu columns stage 1 turns into the GELU chunk itself (+ b1,
// GELU, bf16 into chunk buffer k % 2 once both stage-2 warpgroups are done
// with the buffer's last round); the rest goes as f32 into products slot k
// % kPStages in fragment order (the column pair m of thread t at 8 (128 m
// + t): conflict-free, and each stage-2 thread reads one stage-1 thread's
// pairs) once stage 2 has turned the slot's last chunk into a GELU chunk:
// that chunk buffer's full barrier. Stage 2 applies b1 and the GELU to
// those (s2_narrow_gelu), so that stage 1 goes on to the next chunk's
// products sooner.
template <int kH, typename V>
__device__ __forceinline__ void s1_narrow(const CUtensorMap* w1_map, const V* __restrict__ b1,
                                          uint32_t base, int c_begin, int c_end, int n_w1,
                                          int warp, int lane, bool leader) {
  using P = Ffn<kH>;
  const int tid = threadIdx.x % 128;
  const int wrow = 16 * (warp % 4) + lane / 4;  // this thread's first row
  int g = 0;  // W1 tiles consumed
  for (int c = c_begin; c < c_end; ++c) {
    const int k = c - c_begin;
    const int hs = k % kHStages;
    const int ps = k % P::kPStages;
    float acc[P::kChains][32];
    s1_pass<kH>(acc, g, w1_map, base, c_begin, 0, n_w1, leader);
    if constexpr (P::kS1Gelu > 0) {
      mbar_wait(base + P::kBarHEmpty + 8 * hs, ((k / kHStages) & 1) ^ 1);
      const uint32_t hbuf = base + P::kOffH + hs * kBlockBytes;
      // every b1 value before the first store: the stores' memory clobber
      // keeps a load after them from being issued before them
      float bb[P::kS1Gelu / 4];
#pragma unroll
      for (int i = 0; i < P::kS1Gelu / 4; ++i)
        bb[i] = ld_f32(b1 + c * kFC + 8 * (i / 2) + 2 * (lane % 4) + i % 2);
#pragma unroll
      for (int nb = 0; nb < P::kS1Gelu / 8; ++nb) {
        const int col = 8 * nb + 2 * (lane % 4);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          mrd::sts_pair(hbuf + sw128_offset(wrow + 8 * hr, col >> 3, kBlockBytes) + (col & 7) * 2,
                        gelu_pair(acc[0][4 * nb + 2 * hr] + bb[2 * nb],
                                  acc[0][4 * nb + 2 * hr + 1] + bb[2 * nb + 1]));
      }
      fence_proxy_async();  // the stores, to stage 2's wgmma
      mbar_arrive(base + P::kBarHFull + 8 * hs);
    }
    if (k >= P::kPStages) {  // the GELU of the slot's last chunk, k - kPStages, is whole
      const int j = k - P::kPStages;
      mbar_wait(base + P::kBarHFull + 8 * (j % kHStages), (j / kHStages) & 1);
    }
    const uint32_t slot = base + P::kOffP + ps * P::kPBytes + 8 * tid;
#pragma unroll
    for (int m = P::kS1Gelu / 4; m < 16; ++m)
      mrd::sts_f32x2(slot + 8 * 128 * m, acc[0][2 * m], acc[0][2 * m + 1]);
    mbar_arrive(base + P::kBarPFull + 8 * ps);
  }
}

// kNarrow, the stage-2 warpgroups at chunk k (slice chunk c): once stage 1
// has stored the chunk's products and both warpgroups are done with chunk
// buffer k % 2's last round, h = bf16(GELU(P + b1)) into it for the columns
// past stage 1's kS1Gelu. Thread s takes kPairs of the column pairs m >=
// kS1Gelu / 4 of stage-1 thread t = s % 128, warpgroup s / 128 the first
// or the second half of them: rows 16 (t / 32) + (t % 32) / 4 (+ 8),
// columns 8 (m / 2) + 2 (t % 4) and + 1. Every thread's arrival on the
// buffer's full barrier, which s2_chunk waits for, says its part is written
// and its products read.
template <int kH, typename V>
__device__ __forceinline__ void s2_narrow_gelu(uint32_t base, const V* __restrict__ b1, int c,
                                               int k) {
  using P = Ffn<kH>;
  const int hs = k % kHStages;
  mbar_wait(base + P::kBarPFull + 8 * (k % P::kPStages), (k / P::kPStages) & 1);
  mbar_wait(base + P::kBarHEmpty + 8 * hs, ((k / kHStages) & 1) ^ 1);
  const int s = threadIdx.x;  // 0 .. 255
  const int t = s % 128, w = t / 32, l = t % 32;
  const uint32_t slot = base + P::kOffP + (k % P::kPStages) * P::kPBytes + 8 * t;
  const uint32_t hbuf = base + P::kOffH + hs * kBlockBytes;
  constexpr int kPairs = (16 - P::kS1Gelu / 4) / 2;  // even: m % 2 is i % 2
  // in batches of kBatch pairs, each batch's loads (products and b1) before
  // its stores (the stores' memory clobber keeps a load after them from
  // being issued before them); at 640, where stage 2's 160 accumulators
  // leave the fewest registers, two pairs at a time in a loop
  constexpr int kBatch = kH == 640 ? 2 : kPairs;
  constexpr int kUnroll = kH == 640 ? 1 : kPairs / kBatch;
#pragma unroll (kUnroll)
  for (int i0 = 0; i0 < kPairs; i0 += kBatch) {
    float2 v[kBatch];
#pragma unroll
    for (int i = i0; i < i0 + kBatch; ++i) {
      const int m = P::kS1Gelu / 4 + kPairs * (s / 128) + i;
      const int col = 8 * (m / 2) + 2 * (l % 4);
      v[i - i0] = mrd::lds_f32x2(slot + 8 * 128 * m);
      v[i - i0].x += ld_f32(b1 + c * kFC + col);
      v[i - i0].y += ld_f32(b1 + c * kFC + col + 1);
    }
#pragma unroll
    for (int i = i0; i < i0 + kBatch; ++i) {
      const int m = P::kS1Gelu / 4 + kPairs * (s / 128) + i;
      const int r = 16 * w + l / 4 + 8 * (i % 2), col = 8 * (m / 2) + 2 * (l % 4);
      mrd::sts_pair(hbuf + sw128_offset(r, col >> 3, kBlockBytes) + (col & 7) * 2,
                    gelu_pair(v[i - i0].x, v[i - i0].y));
    }
  }
  fence_proxy_async();  // the chunk, to the wgmma
  mbar_arrive(base + P::kBarHFull + 8 * hs);
}

// kNarrow's prologue: the bf16 x tile, one warp per row as the other
// forms, the warp's rows (warp + 12 i) all at once: every row's loads are
// issued first, and K1's LayerNorm (LN0) runs each of its steps on all of
// them together, so that the butterflies of the rows' sums overlap (a row
// at a time, each row waited for its loads and its ten shuffles in turn:
// ~1,100 clk a row, two thirds of a tile's prologue). Each row's arithmetic
// is rows.cuh's load_x_row (16-byte groups, H = 256, 512) or
// load_x_row_narrow (8-byte groups, 128, 384, 640) in the same order, so
// split_reduce, which takes x from those, sees the same bits. Rows past M
// are zeros.
template <int kH, typename V, bool kInputLN, typename G>
__device__ __forceinline__ void x_tile_rows(unsigned char* xt, const bf16* __restrict__ z,
                                            long long row0, int M, const V* __restrict__ g0,
                                            const V* __restrict__ o0, float eps, int warp,
                                            int lane) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kRows = (kTM + kWarps - 1) / kWarps;  // rows a warp takes
  constexpr int kG = kH * 2 / sizeof(G) / 32;          // groups a lane holds
  constexpr int kE = sizeof(G) / 2;                    // values a group holds
  G g[kRows][kG];
  bool valid[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    valid[i] = r < kTM && row0 + r < M;
    const G* src = reinterpret_cast<const G*>(z + (row0 + r) * kH);
#pragma unroll
    for (int j = 0; j < kG; ++j) g[i][j] = valid[i] ? src[lane + 32 * j] : G{};
  }
  if constexpr (kInputLN) {
    float s[kRows], q[kRows], mu[kRows], rstd[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      s[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&g[i][j]);
#pragma unroll
        for (int e = 0; e < kE / 2; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          s[i] += f.x + f.y;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      mu[i] = s[i] * (1.0f / kH);
      q[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&g[i][j]);
#pragma unroll
        for (int e = 0; e < kE / 2; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          q[i] += (f.x - mu[i]) * (f.x - mu[i]);
          q[i] += (f.y - mu[i]) * (f.y - mu[i]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < kRows; ++i) q[i] += __shfl_xor_sync(0xffffffffu, q[i], off);
#pragma unroll
    for (int i = 0; i < kRows; ++i) rstd[i] = rsqrtf(q[i] * (1.0f / kH) + eps);
#pragma unroll
    for (int j = 0; j < kG; ++j) {
#pragma unroll
      for (int e = 0; e < kE / 2; ++e) {
        const int cc = kE * (lane + 32 * j) + 2 * e;
        const float ga = mrd::ld_f32(g0 + cc), gb = mrd::ld_f32(g0 + cc + 1);
        const float oa = mrd::ld_f32(o0 + cc), ob = mrd::ld_f32(o0 + cc + 1);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (!valid[i]) continue;  // zeros, as the loaders leave them
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&g[i][j]);
          const float2 f = __bfloat1622float2(p[e]);
          p[e] = __floats2bfloat162_rn((f.x - mu[i]) * rstd[i] * ga + oa,
                                       (f.y - mu[i]) * rstd[i] * gb + ob);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = warp + kWarps * i;
    if (r >= kTM) continue;
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      if constexpr (sizeof(G) == 8)  // 8-byte groups: columns 4 (lane + 32 j) ..
        *reinterpret_cast<uint2*>(xt + sw128_offset(r, lane / 2 + 16 * j, kBlockBytes) +
                                  8 * (lane % 2)) = g[i][j];
      else
        *reinterpret_cast<uint4*>(xt + sw128_offset(r, lane + 32 * j, kBlockBytes)) = g[i][j];
    }
  }
}

// V: the type of the bias and LayerNorm vectors (float or bf16; bf16 only
// for K2); kInputLN: K1 (LN0 of z in the prologue) or K2 (z is x; g0, o0
// unused). Grid: (row tiles, slices of F, column groups); with one slice
// and one group the block applies LN2 and writes y, otherwise it writes its
// f32 partial of h . W2 to `partial` [slices, M, kH] and split_reduce
// (rows.cuh) finishes the rows.
template <int kH, typename V, bool kInputLN>
__global__ void __launch_bounds__(kThreads, 1)
ffn_ln_kernel(const __grid_constant__ CUtensorMap w1_map,  // W1^T [F, H]
              const __grid_constant__ CUtensorMap w2_map,  // W2^T [H, F]
              const bf16* __restrict__ z,                  // [M, H]
              const V* __restrict__ b1,                    // [F]
              const V* __restrict__ b2,                    // [H]
              const V* __restrict__ gamma,
              const V* __restrict__ beta,
              const V* __restrict__ g0,                    // LN0 scale [H] (K1)
              const V* __restrict__ o0,                    // LN0 bias [H] (K1)
              bf16* __restrict__ y,                        // [M, H]
              float* __restrict__ partial,                 // [slices, M, H]
              int M, int chunks_per_slice, float eps) {
  using P = Ffn<kH>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int c_begin = blockIdx.y * chunks_per_slice;
  const int c_end = c_begin + chunks_per_slice;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTM;
  // the pair's rank (its column group: grid z, the cluster's z) and the
  // block's first output column
  const int rank = P::kPair ? static_cast<int>(mrd::cluster_ctarank()) : 0;
  const int col0 = rank * P::kCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const int n_w1 = chunks_per_slice * P::kW1PerChunk;  // tiles of this slice
  const int n_w2 = chunks_per_slice * P::kW2PerChunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kW1Stages; ++s) mbar_init(base + P::kBarW1Full + 8 * s, 1);
    for (int s = 0; s < P::kW2Stages; ++s) mbar_init(base + P::kBarW2Full + 8 * s, 1);
    for (int s = 0; s < kHStages; ++s) {
      if constexpr (P::kWide)  // the peer's half arrives as one copy
        mbar_init(base + P::kBarHFull + 8 * s, 1);
      else if constexpr (P::kAlt)  // the peer's buffer arrives as one copy
        mbar_init(base + P::kBarHFull + 8 * s, s == rank ? P::kHFullArrivals : 1);
      else
        mbar_init(base + P::kBarHFull + 8 * s, P::kHFullArrivals);
      mbar_init(base + P::kBarHEmpty + 8 * s, P::kHEmptyArrivals);
    }
    if constexpr (P::kPair)  // every stage-2 thread of the peer, per exchange
      for (int s = 0; s < 2; ++s) mbar_init(base + P::kBarStats + 8 * s, kS2Threads);
    if constexpr (P::kNarrow)  // the products slots: every stage-1 thread's stores
      for (int s = 0; s < P::kPStages; ++s) mbar_init(base + P::kBarPFull + 8 * s, 128);
    if constexpr (P::kWide)  // the partials: the peer's as bytes, the block's own
      for (int s = 0; s < kHStages; ++s) {
        mbar_init(base + P::kBarPFull + 8 * s, 1);
        mbar_init(base + P::kBarPEmpty + 8 * s, 1);
        mbar_init(base + P::kBarOFull + 8 * s, 128);
        mbar_init(base + P::kBarOEmpty + 8 * s, 1);
        if (s < chunks_per_slice) {  // the first round of the peer's bytes
          mbar_arrive_expect_tx(base + P::kBarPFull + 8 * s, P::kPBytes);
          mbar_arrive_expect_tx(base + P::kBarHFull + 8 * s, kBlockBytes / 2);
        }
      }
    fence_barrier_init();
    // fill both rings; from here on, consumers refill the slots they free
    if constexpr (P::kAlt) {
      for (int g = 0; g < P::kW1Stages && g < w1_tiles<kH>(chunks_per_slice, rank); ++g)
        load_w1<kH>(&w1_map, base, c_begin, rank, g);
      if (chunks_per_slice > (rank ^ 1))  // the peer's first chunk, by bulk copy
        mbar_arrive_expect_tx(base + P::kBarHFull + 8 * (rank ^ 1), kBlockBytes);
    } else {
      for (int g = 0; g < P::kW1Stages && g < n_w1; ++g)
        load_w1<kH>(&w1_map, base, c_begin, rank, g);
    }
    for (int g = 0; g < P::kW2Stages && g < n_w2; ++g)
      load_w2<kH>(&w2_map, base, c_begin, col0, g);
  }
  // prologue, all 12 warps: the bf16 x tile, one warp per row
  if constexpr (P::kNarrow) {
    using G = std::conditional_t<kH % 256 != 0, uint2, uint4>;
    x_tile_rows<kH, V, kInputLN, G>(smem + P::kOffX, z, row0, M, g0, o0, eps, warp, lane);
  } else {
    for (int r = warp; r < kTM; r += kThreads / 32) {
      if constexpr (P::kWide) {
        // the whole row (LN0's statistics), this block's columns into the tile
        if constexpr (kH % 256 != 0) {
          uint2 g[kRowGroups8<kH>];
          if constexpr (kInputLN)
            load_x_row_ln0<kH, V>(z, row0 + r, M, g0, o0, eps, lane, g);
          else
            load_x_row_narrow<kH, V, false>(z, row0 + r, M, g0, o0, eps, lane, g);
#pragma unroll
          for (int j = 0; j < kRowGroups8<kH>; ++j) {
            const int q = lane + 32 * j - col0 / 4;  // the 8-byte group in the block's columns
            if (q >= 0 && q < P::kCols / 4)
              *reinterpret_cast<uint2*>(smem + P::kOffX + sw128_offset(r, q / 2, kBlockBytes) +
                                        8 * (q % 2)) = g[j];
          }
        } else {
          uint4 g[kRowGroupsPerLane<kH>];
          if constexpr (kInputLN)
            load_x_row_ln0<kH, V>(z, row0 + r, M, g0, o0, eps, lane, g);
          else
            load_x_row<kH, V, false>(z, row0 + r, M, g0, o0, eps, lane, g);
#pragma unroll
          for (int j = 0; j < kRowGroupsPerLane<kH>; ++j) {
            const int q = lane + 32 * j - col0 / 8;  // the 16-byte group in the block's columns
            if (q >= 0 && q < P::kCols / 8)
              *reinterpret_cast<uint4*>(smem + P::kOffX + sw128_offset(r, q, kBlockBytes)) = g[j];
          }
        }
      } else if constexpr (kH % 256 != 0) {  // 8-byte groups: columns 4 (lane + 32 j) ..
        uint2 g[kRowGroups8<kH>];
        load_x_row_narrow<kH, V, kInputLN>(z, row0 + r, M, g0, o0, eps, lane, g);
#pragma unroll
        for (int j = 0; j < kRowGroups8<kH>; ++j)
          *reinterpret_cast<uint2*>(smem + P::kOffX +
                                    sw128_offset(r, lane / 2 + 16 * j, kBlockBytes) +
                                    8 * (lane % 2)) = g[j];
      } else {
        uint4 g[kRowGroupsPerLane<kH>];
        load_x_row<kH, V, kInputLN>(z, row0 + r, M, g0, o0, eps, lane, g);
#pragma unroll
        for (int j = 0; j < kRowGroupsPerLane<kH>; ++j)
          *reinterpret_cast<uint4*>(smem + P::kOffX +
                                    sw128_offset(r, lane + 32 * j, kBlockBytes)) = g[j];
      }
    }
  }
  fence_proxy_async();
  if constexpr (P::kPair)
    mrd::cluster_sync();  // both blocks' barriers are initialized
  else
    __syncthreads();

  const int role = threadIdx.x / 128;
  const int wrow = 16 * (warp % 4) + lane / 4;  // this thread's first row
  const bool leader = threadIdx.x % 128 == 0;
  if (role == kS1WG) {
    // ---- stage 1: the GELU chunk h = bf16(GELU(x . W1[:, chunk] + b1)),
    // in two passes of 32 columns
    if constexpr (P::kRegs1 != 168)  // (kNarrow below 512 keeps the launch's 168)
      mrd::setmaxnreg_dec<P::kRegs1>();
    if constexpr (P::kWide) {
      s1_wide<kH>(&w1_map, base, c_begin, c_end, n_w1, rank, leader);
    } else if constexpr (P::kNarrow) {
      s1_narrow<kH, V>(&w1_map, b1, base, c_begin, c_end, n_w1, warp, lane, leader);
    } else if constexpr (P::kAlt) {
      s1_alt<kH, V>(&w1_map, b1, base, c_begin, c_end, w1_tiles<kH>(chunks_per_slice, rank),
                    rank, warp, lane, leader);
    } else {
      Ring w1;
      int g = 0;  // W1 tiles consumed
      for (int c = c_begin; c < c_end; ++c) {
        const int k = c - c_begin;
        const int hs = k % kHStages;
        unsigned char* hbuf = smem + P::kOffH + hs * kBlockBytes;
        // (kPair is false here; the expressions on it are kept as they were
        // written when this loop served the pairs too, since another form of
        // the same math moves ptxas's schedule of the one-block widths)
        const uint32_t peer_h =
            P::kPair ? mrd::map_to_rank(base + P::kOffH + hs * kBlockBytes, rank ^ 1) : 0;
#pragma unroll 1
        for (int half = P::kPair ? rank : 0; half < (P::kPair ? rank + 1 : 2); ++half) {
          // P[64, 32] = x . W1[:, f0 + 32 half .. +32], one wgmma group in
          // flight while the next tile's wait and issue proceed
          float p[16];
#pragma unroll
          for (int t = 0; t < P::kW1PerHalf; ++t, ++g) {
            mbar_wait(base + P::kBarW1Full + 8 * w1.slot, w1.phase);
            const uint32_t a0 = opaque(base) + P::kOffX + P::kW1Boxes * t * kBlockBytes;
            const uint32_t b0 = opaque(base) + P::kOffW1 + w1.slot * P::kW1Bytes;
            if (t > 0) mrd::fence_operand(p);
            mrd::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < P::kW1K / 16; ++kk) {
              const uint64_t da = sw128_desc(a0 + (kk / 4) * kBlockBytes + (kk % 4) * 32);
              const uint64_t db = sw128_desc(b0 + (kk / 4) * kW1BoxBytes + (kk % 4) * 32);
              if (t == 0 && kk == 0)
                mrd::wgmma_m64n32k16_first(p, da, db);
              else
                mrd::wgmma_m64n32k16(p, da, db, 1);
            }
            mrd::wgmma_commit();
            mrd::fence_operand(p);
            if (t > 0) {
              mrd::wgmma_wait<1>();
              if (leader && g - 1 + P::kW1Stages < n_w1)
                load_w1<kH>(&w1_map, base, c_begin, rank, g - 1 + P::kW1Stages);
            }
            w1.next<P::kW1Stages>();
          }
          mrd::wgmma_wait<0>();
          mrd::fence_operand(p);
          if (leader && g - 1 + P::kW1Stages < n_w1)
            load_w1<kH>(&w1_map, base, c_begin, rank, g - 1 + P::kW1Stages);
          // + b1, exact-erf GELU in f32, bf16 into the chunk's H slot once
          // stage 2 has released it
          if (half == 0) mbar_wait(base + P::kBarHEmpty + 8 * hs, ((k / kHStages) & 1) ^ 1);
#pragma unroll
          for (int nb = 0; nb < kS1N / 8; ++nb) {
            const int col = kS1N * half + 8 * nb + 2 * (lane % 4);
            const float bb0 = ld_f32(b1 + c * kFC + col);
            const float bb1 = ld_f32(b1 + c * kFC + col + 1);
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int r = wrow + 8 * hr;
              const float v0 = p[4 * nb + 2 * hr] + bb0;
              const float v1 = p[4 * nb + 2 * hr + 1] + bb1;
              *reinterpret_cast<__nv_bfloat162*>(hbuf + sw128_offset(r, col >> 3, kBlockBytes) +
                                                 (col & 7) * 2) =
                  __floats2bfloat162_rn(0.5f * v0 * (1.0f + erff(v0 * 0.70710678118654752f)),
                                        0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f)));
            }
          }
        }
        fence_proxy_async();  // the stores, to stage 2's wgmma
        mbar_arrive(base + P::kBarHFull + 8 * hs);
      }
    }
  } else {
    // ---- stage 2, warpgroup wg: ACC[:, col0 + kHalf wg .. + kHalf] +=
    // h . W2[chunk, ...]
    if constexpr (P::kRegs2 != 168) mrd::setmaxnreg_inc<P::kRegs2>();
    const int wg = role;
    float acc[P::kW2PerChunk / kS2][P::kAcc];  // [64, kHalf] f32: n128 (n64) tiles
    Ring w2;
    if constexpr (P::kWide)
      s2_gelu<kH, V>(base, b1, c_begin, 0, chunks_per_slice, rank, wg, leader);
    else if constexpr (P::kNarrow)
      s2_narrow_gelu<kH, V>(base, b1, c_begin, 0);
    s2_chunk<kH, true>(acc, w2, &w2_map, base, c_begin, col0, n_w2, 0, wg, leader, rank);
    for (int k = 1; k < chunks_per_slice; ++k) {
      if constexpr (P::kWide)
        s2_gelu<kH, V>(base, b1, c_begin + k, k, chunks_per_slice, rank, wg, leader);
      else if constexpr (P::kNarrow)
        s2_narrow_gelu<kH, V>(base, b1, c_begin + k, k);
      s2_chunk<kH, false>(acc, w2, &w2_map, base, c_begin, col0, n_w2, k, wg, leader, rank);
    }

    // ---- epilogue. Thread (warp, lane) holds rows wrow and wrow + 8, and
    // per n8 block nb of tile j the columns col0 + kHalf wg + 128 j + 8 nb +
    // 2 (lane % 4) and + 1: acc[j][4 nb + 2 half + e] is (wrow + 8 half,
    // col + e)
    const unsigned char* xt = smem + P::kOffX;
    // kWide: the tile holds x's columns col0 .. + kCols, at whose blocks
    // pair_at then lands for the global column
    if constexpr (P::kWide) xt -= col0 / 64 * kBlockBytes;
    float* red = reinterpret_cast<float*>(smem + P::kOffRed);
    if (gridDim.y > 1) {  // split-F: the f32 partial of the valid rows
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long gr = row0 + wrow + 8 * half;
        if (gr < M) {
          float* dst = partial + (static_cast<long long>(blockIdx.y) * M + gr) * kH;
#pragma unroll
          for (int j = 0; j < P::kW2PerChunk / kS2; ++j)
#pragma unroll
            for (int nb = 0; nb < P::kW2N / 8; ++nb) {
              const int col = col0 + P::kHalf * wg + P::kW2N * j + 8 * nb + 2 * (lane % 4);
              *reinterpret_cast<float2*>(dst + col) =
                  make_float2(acc[j][4 * nb + 2 * half], acc[j][4 * nb + 2 * half + 1]);
            }
        }
      }
      if constexpr (P::kPair) mrd::cluster_sync();  // the peer is done with this block
      return;
    }
    if constexpr (P::kPair) {
      // LN2 over the pair: + b2 + x, then the row sums of this warpgroup's
      // 256 columns into both blocks' exchange, the mean of all four, the
      // centred squares the same way, and y for the block's columns. Each
      // exchange is a store to this block's and the peer's values and an
      // arrival on the peer's barrier; both blocks add the four partials in
      // one order, so they share the statistics bit for bit
      float* stats = reinterpret_cast<float*>(smem + P::kOffW1);
      const uint32_t peer_stats = mrd::map_to_rank(base + P::kOffW1, rank ^ 1);
      const uint32_t peer_bar = mrd::map_to_rank(base + P::kBarStats, rank ^ 1);
      const int mine = (rank * kS2 + wg) * kTM;  // this warpgroup's rows
      float s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < P::kW2PerChunk / kS2; ++j)
#pragma unroll
        for (int nb = 0; nb < P::kW2N / 8; ++nb) {
          const int col = col0 + P::kHalf * wg + P::kW2N * j + 8 * nb + 2 * (lane % 4);
          const float bb0 = ld_f32(b2 + col), bb1 = ld_f32(b2 + col + 1);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 x2 = pair_at(xt, wrow + 8 * half, col);
            float& a0 = acc[j][4 * nb + 2 * half];
            float& a1 = acc[j][4 * nb + 2 * half + 1];
            a0 = a0 + bb0 + x2.x;
            a1 = a1 + bb1 + x2.y;
            s[half] += a0 + a1;
          }
        }
      float mu[2], rstd[2];
#pragma unroll
      for (int step = 0; step < 2; ++step) {  // sums, then centred squares
        float* vals = stats + step * 2 * kS2 * kTM;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
          s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
          const int at = step * 2 * kS2 * kTM + mine + wrow + 8 * half;
          if (lane % 4 == 0) {
            stats[at] = s[half];
            mrd::st_cluster_b32(peer_stats + 4 * at, __float_as_uint(s[half]));
          }
        }
        mrd::mbar_arrive_remote(peer_bar + 8 * step);
        named_bar_sync<kS2Threads>(1);  // this block's two warpgroups
        mrd::mbar_wait_cluster(base + P::kBarStats + 8 * step, 0);  // the peer's
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wrow + 8 * half;
          const float total = (vals[r] + vals[kTM + r]) + (vals[2 * kTM + r] + vals[3 * kTM + r]);
          if (step == 0) {
            mu[half] = total * (1.0f / kH);
            s[half] = 0.0f;
          } else {
            rstd[half] = rsqrtf(total * (1.0f / kH) + eps);
          }
        }
        if (step == 0) {
#pragma unroll
          for (int j = 0; j < P::kW2PerChunk / kS2; ++j)
#pragma unroll
            for (int i = 0; i < P::kAcc; ++i) {
              const float d = acc[j][i] - mu[(i / 2) % 2];
              s[(i / 2) % 2] += d * d;
            }
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long gr = row0 + wrow + 8 * half;
        if (gr < M) {
          bf16* dst = y + gr * kH;
#pragma unroll
          for (int j = 0; j < P::kW2PerChunk / kS2; ++j)
#pragma unroll
            for (int nb = 0; nb < P::kW2N / 8; ++nb) {
              const int col = col0 + P::kHalf * wg + P::kW2N * j + 8 * nb + 2 * (lane % 4);
              const float a0 = acc[j][4 * nb + 2 * half], a1 = acc[j][4 * nb + 2 * half + 1];
              *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
                  (a0 - mu[half]) * rstd[half] * ld_f32(gamma + col) + ld_f32(beta + col),
                  (a1 - mu[half]) * rstd[half] * ld_f32(gamma + col + 1) +
                      ld_f32(beta + col + 1));
            }
        }
      }
      mrd::cluster_sync();  // the peer is done with this block
    } else {
      // + b2 + x, and the row sums of this warpgroup's kHalf columns
      float s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < P::kW2PerChunk / kS2; ++j)
#pragma unroll
        for (int nb = 0; nb < P::kW2N / 8; ++nb) {
          const int col = P::kHalf * wg + P::kW2N * j + 8 * nb + 2 * (lane % 4);
          const float bb0 = ld_f32(b2 + col), bb1 = ld_f32(b2 + col + 1);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 x2 = pair_at(xt, wrow + 8 * half, col);
            float& a0 = acc[j][4 * nb + 2 * half];
            float& a1 = acc[j][4 * nb + 2 * half + 1];
            a0 = a0 + bb0 + x2.x;
            a1 = a1 + bb1 + x2.y;
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
      named_bar_sync<kS2Threads>(1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wrow + 8 * half;
        mu[half] = (red[r] + red[kTM + r]) * (1.0f / kH);
        s[half] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < P::kW2PerChunk / kS2; ++j)
#pragma unroll
        for (int i = 0; i < P::kAcc; ++i) {
          const float d = acc[j][i] - mu[(i / 2) % 2];
          s[(i / 2) % 2] += d * d;
        }
      float* red_q = red + kS2 * kTM;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
        s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
        if (lane % 4 == 0) red_q[wg * kTM + wrow + 8 * half] = s[half];
      }
      named_bar_sync<kS2Threads>(1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wrow + 8 * half;
        rstd[half] = rsqrtf((red_q[r] + red_q[kTM + r]) * (1.0f / kH) + eps);
      }
      if constexpr (P::kStageY) {
        // y into the x tile, each thread at the positions whose residual it
        // read, then the tile's valid rows out in 16-byte groups: whole
        // 128-byte lines, where a thread's bf16 pairs filled 16 bytes of
        // each 32-byte sector
        unsigned char* yt = smem + P::kOffX;
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < P::kW2PerChunk / kS2; ++j)
#pragma unroll
            for (int nb = 0; nb < P::kW2N / 8; ++nb) {
              const int col = P::kHalf * wg + P::kW2N * j + 8 * nb + 2 * (lane % 4);
              const float a0 = acc[j][4 * nb + 2 * half], a1 = acc[j][4 * nb + 2 * half + 1];
              *reinterpret_cast<__nv_bfloat162*>(
                  yt + sw128_offset(wrow + 8 * half, col >> 3, kBlockBytes) + (col & 7) * 2) =
                  __floats2bfloat162_rn(
                      (a0 - mu[half]) * rstd[half] * ld_f32(gamma + col) + ld_f32(beta + col),
                      (a1 - mu[half]) * rstd[half] * ld_f32(gamma + col + 1) +
                          ld_f32(beta + col + 1));
            }
        named_bar_sync<kS2Threads>(1);
        for (int i = threadIdx.x; i < kTM * kH / 8; i += kS2Threads) {
          const int r = i / (kH / 8), g = i % (kH / 8);
          if (row0 + r < M)
            *reinterpret_cast<uint4*>(y + (row0 + r) * kH + 8 * g) =
                *reinterpret_cast<const uint4*>(yt + sw128_offset(r, g, kBlockBytes));
        }
      } else {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long gr = row0 + wrow + 8 * half;
          if (gr < M) {
            bf16* dst = y + gr * kH;
#pragma unroll
            for (int j = 0; j < P::kW2PerChunk / kS2; ++j)
#pragma unroll
              for (int nb = 0; nb < P::kW2N / 8; ++nb) {
                const int col = P::kHalf * wg + P::kW2N * j + 8 * nb + 2 * (lane % 4);
                const float a0 = acc[j][4 * nb + 2 * half], a1 = acc[j][4 * nb + 2 * half + 1];
                *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
                    (a0 - mu[half]) * rstd[half] * ld_f32(gamma + col) + ld_f32(beta + col),
                    (a1 - mu[half]) * rstd[half] * ld_f32(gamma + col + 1) +
                        ld_f32(beta + col + 1));
              }
          }
        }
      }
    }
  }
}

template <int kH, typename V, bool kInputLN>
cudaError_t launch(const void* z, const void* w1t, const void* b1, const void* w2t,
                   const void* b2, const void* gamma, const void* beta, const void* g0,
                   const void* o0, void* y, void* scratch, int M, int F, int slices,
                   float eps, cudaStream_t stream) {
  using P = Ffn<kH>;
  CUtensorMap w1_map, w2_map;
  if (!make_map(&w1_map, w1t, F, kH, P::kS1Cols) || !make_map(&w2_map, w2t, kH, F, P::kW2N))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ffn_ln_kernel<kH, V, kInputLN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(P::kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kTM - 1) / kTM, slices, P::kGroups);
  const auto vec = [](const void* p) { return static_cast<const V*>(p); };
  const auto* zb = static_cast<const bf16*>(z);
  if constexpr (P::kPair) {
    // the two column groups of a row tile and slice as one cluster
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = P::kGroups;
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = P::kSmemBytes;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, ffn_ln_kernel<kH, V, kInputLN>, w1_map, w2_map, zb,
                             vec(b1), vec(b2), vec(gamma), vec(beta), vec(g0), vec(o0),
                             static_cast<bf16*>(y), static_cast<float*>(scratch), M,
                             F / kFC / slices, eps);
    if (err != cudaSuccess) return err;
  } else {
    ffn_ln_kernel<kH, V, kInputLN><<<grid, kThreads, P::kSmemBytes, stream>>>(
        w1_map, w2_map, zb, vec(b1), vec(b2), vec(gamma), vec(beta), vec(g0), vec(o0),
        static_cast<bf16*>(y), static_cast<float*>(scratch), M, F / kFC / slices, eps);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  split_reduce<kH, V, kInputLN><<<(M + 7) / 8, 256, 0, stream>>>(
      static_cast<const float*>(scratch), slices, zb, vec(b2), vec(gamma), vec(beta),
      vec(g0), vec(o0), static_cast<bf16*>(y), M, eps);
  return cudaGetLastError();
}

// The clusters of a pair form's launch (H >= 896) that the card holds at
// once, cudaOccupancyMaxActiveClusters at the block's shared memory, which
// chip_smoke.py prints; the launch plan does not read it (the H100 holds 66
// pairs: all of its SMs). 0 at the one-block widths, which launch no
// cluster; negative on an error.
template <int kH>
int max_clusters() {
  using P = Ffn<kH>;
  if constexpr (!P::kPair) {
    return 0;
  } else {
    const auto fn = ffn_ln_kernel<kH, bf16, true>;
    if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(P::kSmemBytes)) != cudaSuccess)
      return -1;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = P::kGroups;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(256, 1, P::kGroups);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = P::kSmemBytes;
    config.attrs = attr;
    config.numAttrs = 1;
    int n = 0;
    return cudaOccupancyMaxActiveClusters(&n, fn, &config) == cudaSuccess ? n : -2;
  }
}

cudaError_t check_args(int M, int F, int slices, const void* scratch) {
  if (F <= 0 || slices < 1 || F % (kFC * slices) != 0) return cudaErrorInvalidValue;
  if (slices > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int kH>
int pre_ln_bf16(const void* z, const void* w1t, const void* b1, const void* w2t,
                const void* b2, const void* gamma, const void* beta, const void* g0,
                const void* o0, void* y, void* scratch, int M, int F, int slices, float eps,
                int vec_bf16, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t bad = check_args(M, F, slices, scratch);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec_bf16 ? launch<kH, bf16, true>(z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y, scratch,
                                        M, F, slices, eps, s)
               : launch<kH, float, true>(z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y, scratch,
                                         M, F, slices, eps, s));
}

template <int kH>
int ln_bf16(const void* x, const void* w1t, const void* b1, const void* w2t, const void* b2,
            const void* gamma, const void* beta, void* y, void* scratch, int M, int F,
            int slices, float eps, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t bad = check_args(M, F, slices, scratch);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  return static_cast<int>(launch<kH, bf16, false>(x, w1t, b1, w2t, b2, gamma, beta, nullptr,
                                                  nullptr, y, scratch, M, F, slices, eps,
                                                  static_cast<cudaStream_t>(stream)));
}

}  // namespace

// The C entries of K1, K2, the shared memory per block and the resident
// clusters at a built width H other than 768: `name`_h<H>, as ffn_ln.cu's
// mrd_ffn_smem_bytes, mrd_ffn_max_clusters, mrd_ffn_pre_ln_bf16 and
// mrd_ffn_ln_bf16 with H in place of 768.
#define MRD_FFN_WIDTH(kH)                                                                    \
  int mrd_ffn_smem_bytes_h##kH() { return static_cast<int>(Ffn<kH>::kSmemBytes); }          \
  int mrd_ffn_max_clusters_h##kH() { return max_clusters<kH>(); }                           \
  int mrd_ffn_pre_ln_bf16_h##kH(const void* z, const void* w1t, const void* b1,              \
                                const void* w2t, const void* b2, const void* gamma,          \
                                const void* beta, const void* g0, const void* o0, void* y,   \
                                void* scratch, int M, int F, int slices, float eps,          \
                                int vec_bf16, void* stream) {                                \
    return pre_ln_bf16<kH>(z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y, scratch, M, F,       \
                           slices, eps, vec_bf16, stream);                                   \
  }                                                                                          \
  int mrd_ffn_ln_bf16_h##kH(const void* x, const void* w1t, const void* b1, const void* w2t, \
                            const void* b2, const void* gamma, const void* beta, void* y,    \
                            void* scratch, int M, int F, int slices, float eps,              \
                            void* stream) {                                                  \
    return ln_bf16<kH>(x, w1t, b1, w2t, b2, gamma, beta, y, scratch, M, F, slices, eps,      \
                       stream);                                                              \
  }
