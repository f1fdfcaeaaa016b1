// Pieces of the port's f32 row kernels: the residual row (with LN0 for K1),
// which ffn_ln_f32.cu's passes read, and the SIMT product of attn_out_ln_f32.cu
// (K3-f32): a block's 32 resident rows times a streamed weight matrix, the
// ring of weight tiles that feeds it and the LayerNorm epilogue. Everything
// is in f32: operands, products and sums are IEEE single precision (FFMA),
// never rounded to TF32. Everything is in an anonymous namespace: each
// source that includes it gets its own copy.
//
// The block: 32 rows and 256 threads (8 warps). Warp w owns rows
// 8 (w % 4) .. + 8 and, in the [32, 768] output product, the columns
// 384 (w / 4) + lane + 32 i, i < 12: an [8, 12] f32 accumulator per thread,
// 96 registers. The rows' A operand sits in shared memory in row-major f32
// and is read as float4 along k, the same address across the warp (a
// broadcast); the weights arrive as tiles [n][k] of nn.Linear's [out, in]
// layout, each row's float4s swizzled so that the 8 lanes of each phase of
// a 128-bit shared load hit 8 distinct 16-byte bank groups.

#pragma once

#include "common.cuh"

namespace {

constexpr int kF32H = 768;                        // hidden width (BERT-base)
constexpr int kF32TM = 32;                        // rows per block
constexpr int kF32Threads = 256;                  // 8 warps
constexpr int kF32RowsPerWarp = 8;                // a warp's row group
constexpr int kF32ColGroups = 2;                  // warps per row group
constexpr int kF32Cols = kF32H / kF32ColGroups / 32;  // 12 output columns per lane
constexpr int kF32RowVecs = kF32H / 4 / 32;       // float4s per lane of a row: 6

static_assert(kF32Threads / 32 == (kF32TM / kF32RowsPerWarp) * kF32ColGroups,
              "one warp per (row group, column group)");

// Output product tiles: 8 k of all 768 output rows of a [768, K] row-major
// matrix (Wo^T), [768][8] f32 = 24 KB; float4 j of row n stored at
// position j ^ ((n >> 2) & 1).
constexpr int kOutTileK = 8;
constexpr int kOutTileFloats = kF32H * kOutTileK;

// Copy the output-product tile of k columns k0 .. k0 + 8 of `bt` [768, ldb]
// into `tile` (this thread's 6 of its 1,536 16-byte pieces, one sector per
// row).
__device__ __forceinline__ void load_out_tile(float* tile, const float* __restrict__ bt,
                                              long long ldb, long long k0) {
#pragma unroll
  for (int i = 0; i < kOutTileFloats / 4 / kF32Threads; ++i) {
    const int q = threadIdx.x + kF32Threads * i;
    const int n = q >> 1, j = q & 1;
    mrd::cp_async16(tile + n * kOutTileK + 4 * (j ^ ((n >> 2) & 1)), bt + n * ldb + k0 + 4 * j);
  }
}

// acc[r][i] += sum_{k < 8} a[8 rg + r][ka + k] * tile[n_i][k], with a the
// block's rows in shared memory (row stride lda floats), rg = warp % 4 and
// n_i = 384 (warp / 4) + lane + 32 i; k in order, one FFMA per term.
__device__ __forceinline__ void out_tile_step(float (&acc)[kF32RowsPerWarp][kF32Cols],
                                              const float* a, int lda, int ka,
                                              const float* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* arow = a + (kF32RowsPerWarp * (warp % 4)) * lda + ka;
  const float* brow = tile + (kF32H / kF32ColGroups * (warp / 4) + lane) * kOutTileK;
  const int sw = (lane >> 2) & 1;  // (n >> 2) & 1 for every n of this lane
#pragma unroll
  for (int j = 0; j < kOutTileK / 4; ++j) {
    float4 av[kF32RowsPerWarp];
#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r)
      av[r] = *reinterpret_cast<const float4*>(arow + r * lda + 4 * j);
#pragma unroll
    for (int i = 0; i < kF32Cols; ++i) {
      const float4 b = *reinterpret_cast<const float4*>(brow + 32 * i * kOutTileK +
                                                        4 * (j ^ sw));
#pragma unroll
      for (int r = 0; r < kF32RowsPerWarp; ++r) {
        float s = acc[r][i];
        s = fmaf(av[r].x, b.x, s);
        s = fmaf(av[r].y, b.y, s);
        s = fmaf(av[r].z, b.z, s);
        s = fmaf(av[r].w, b.w, s);
        acc[r][i] = s;
      }
    }
  }
}

// The ring of weight tiles: kF32Stages slots of `slot_floats`, filled by
// cp.async groups. advance() is called once per tile, in order, by every
// thread: it waits for tile g, makes it visible to the block (one
// __syncthreads, which also retires every read of tile g - 1's slot), issues
// tile g + kF32Stages - 1 into that slot through `issue(tile, slot)` and
// returns tile g's slot.
constexpr int kF32Stages = 3;

template <typename Issue>
__device__ __forceinline__ const float* ring_advance(float* ring, int slot_floats, int g,
                                                     int n_tiles, Issue&& issue) {
  mrd::cp_async_wait<kF32Stages - 2>();
  __syncthreads();
  const int next = g + kF32Stages - 1;
  if (next < n_tiles) issue(next, ring + (next % kF32Stages) * slot_floats);
  mrd::cp_async_commit();
  return ring + (g % kF32Stages) * slot_floats;
}

template <typename Issue>
__device__ __forceinline__ void ring_start(float* ring, int slot_floats, int n_tiles,
                                           Issue&& issue) {
#pragma unroll
  for (int g = 0; g < kF32Stages - 1; ++g) {
    if (g < n_tiles) issue(g, ring + g * slot_floats);
    mrd::cp_async_commit();
  }
}

// Row `gr` of z as 6 float4s per lane (columns 4 (lane + 32 j) .. + 4): LN0
// of z (two-pass statistics, K1) or z itself (K2, K3); zeros past M. One
// warp per row; the FFN's split pass and its LayerNorm pass both take x
// from here, so they see the same bits.
template <bool kInputLN>
__device__ __forceinline__ void load_row_f32(const float* __restrict__ z, long long gr, int M,
                                             const float* __restrict__ g0,
                                             const float* __restrict__ o0, float eps, int lane,
                                             float4 (&out)[kF32RowVecs]) {
  if (gr >= M) {
#pragma unroll
    for (int j = 0; j < kF32RowVecs; ++j) out[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float4* src = reinterpret_cast<const float4*>(z + gr * kF32H);
#pragma unroll
  for (int j = 0; j < kF32RowVecs; ++j) out[j] = src[lane + 32 * j];
  if constexpr (kInputLN) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kF32RowVecs; ++j) s += (out[j].x + out[j].y) + (out[j].z + out[j].w);
    const float mu = mrd::warp_sum(s) * (1.0f / kF32H);
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < kF32RowVecs; ++j) {
      const float4 d = make_float4(out[j].x - mu, out[j].y - mu, out[j].z - mu, out[j].w - mu);
      q += (d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w);
    }
    const float rstd = rsqrtf(mrd::warp_sum(q) * (1.0f / kF32H) + eps);
#pragma unroll
    for (int j = 0; j < kF32RowVecs; ++j) {
      const int c = 4 * (lane + 32 * j);
      const float4 g = *reinterpret_cast<const float4*>(g0 + c);
      const float4 o = *reinterpret_cast<const float4*>(o0 + c);
      out[j] = make_float4((out[j].x - mu) * rstd * g.x + o.x, (out[j].y - mu) * rstd * g.y + o.y,
                           (out[j].z - mu) * rstd * g.z + o.z, (out[j].w - mu) * rstd * g.w + o.w);
    }
  }
}

// The block's rows row0 .. row0 + 32 of z into `xs` [32][768] f32, one
// warp per row.
__device__ __forceinline__ void stage_rows_f32(float* xs, const float* __restrict__ z,
                                               long long row0, int M) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kF32TM; r += kF32Threads / 32) {
    float4 v[kF32RowVecs];
    load_row_f32<false>(z, row0 + r, M, nullptr, nullptr, 0.0f, lane, v);
#pragma unroll
    for (int j = 0; j < kF32RowVecs; ++j)
      *reinterpret_cast<float4*>(xs + r * kF32H + 4 * (lane + 32 * j)) = v[j];
  }
}

// y = LN(acc + b + x) for the block's valid rows, with x from the rows of
// `xg` [M, 768]. Two-pass statistics: each row's sums are taken per thread
// over its 12 columns, across the warp, then across the two warps of the row
// group through `red` (2 x 2 x 32 floats of shared memory).
__device__ __forceinline__ void ln_epilogue_f32(float (&acc)[kF32RowsPerWarp][kF32Cols],
                                                const float* __restrict__ xg,
                                                const float* __restrict__ b,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, float* red,
                                                float* __restrict__ y, long long row0, int M,
                                                float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = kF32RowsPerWarp * (warp % 4), cg = warp / 4;
  const int c0 = kF32H / kF32ColGroups * cg + lane;
  float s[kF32RowsPerWarp];
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    const long long gr = row0 + rg + r;
    s[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kF32Cols; ++i) {
      const int c = c0 + 32 * i;
      const float x = gr < M ? xg[gr * kF32H + c] : 0.0f;
      acc[r][i] = acc[r][i] + b[c] + x;
      s[r] += acc[r][i];
    }
  }
  float mu[kF32RowsPerWarp], rstd[kF32RowsPerWarp];
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    const float t = mrd::warp_sum(s[r]);
    if (lane == 0) red[cg * kF32TM + rg + r] = t;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    mu[r] = (red[rg + r] + red[kF32TM + rg + r]) * (1.0f / kF32H);
    s[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kF32Cols; ++i) {
      const float d = acc[r][i] - mu[r];
      s[r] += d * d;
    }
  }
  float* red_q = red + kF32ColGroups * kF32TM;
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    const float t = mrd::warp_sum(s[r]);
    if (lane == 0) red_q[cg * kF32TM + rg + r] = t;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    rstd[r] = rsqrtf((red_q[rg + r] + red_q[kF32TM + rg + r]) * (1.0f / kF32H) + eps);
    const long long gr = row0 + rg + r;
    if (gr < M) {
#pragma unroll
      for (int i = 0; i < kF32Cols; ++i) {
        const int c = c0 + 32 * i;
        y[gr * kF32H + c] = (acc[r][i] - mu[r]) * rstd[r] * gamma[c] + beta[c];
      }
    }
  }
}

}  // namespace
