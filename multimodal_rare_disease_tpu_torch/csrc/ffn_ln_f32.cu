// K1 and K2 in f32: the post-LN BERT FFN sublayer of a model whose compute
// dtype is float32, written by hand for Hopper (sm_90a). One kernel
// template, `kInputLN`:
//
//   K1 (kInputLN = true):  x = LN0(z)   z: [M, 768] f32, the unnormalized
//                                          attention residual
//   K2 (kInputLN = false): x = z        (the output of K3, attn_out_ln_f32.cu)
//
//   h = GELU(x . W1 + b1)               W1: [768, F] f32, exact-erf GELU
//   y = LN2(x + h . W2 + b2)            W2: [F, 768] f32
//
// Everything is f32 as in the Pallas body run in f32
// (multimodal_rare_disease_tpu/ops/pallas/ffn.py:72-133): operands, products
// and sums are IEEE single precision (FFMA on the CUDA cores, not the tensor
// cores, whose f32 input is TF32 with a 10-bit mantissa); both LayerNorms
// take two-pass statistics (eps given, 1e-12 for BERT). The six vectors are
// f32.
//
// Replaces multimodal_rare_disease_tpu/ops/pallas/ffn.py::_ffn_pre_ln_kernel
// (K1, reached through _fused_ffn_pre_ln_impl) and ::_ffn_ln_kernel (K2,
// through _fused_ffn_ln_impl) where the JAX model runs them in f32
// (training.compute_dtype=float32); ffn_ln.cu is their bf16 form.
//
// What bounds it on the H100: the operations. One call is 4*M*768*F flops
// (154.6 GFLOP at M = 16,384 and F = 3,072: 2.31 ms at the 67 TFLOP/s f32
// rate) against 119 MB of device memory (x and y, 50 MB each, and W1 and W2,
// 18.9 MB). The [M, F] intermediate (201 MB in f32) never goes to device
// memory. An f32 tile is twice a bf16 one: a [64, 768] x tile would be 192 KB
// of the 227 KB of shared memory a block may take, and a [64, 768] f32
// accumulator the whole register file of a 256-thread block, so:
//
// Design:
//   - a block owns 32 rows and 256 threads; the x tile [32, 768] f32 (96 KB)
//     stays in shared memory (LN0 of z for K1, the rows for K2, zeros past
//     M): stage 1's A operand and the epilogue's residual;
//   - per F chunk of 256: stage 1 computes P = x . W1[:, chunk] as an [8, 4]
//     FFMA tile per thread (rows 8 (warp % 4) .., columns 128 (warp / 4) +
//     lane + 32 i), streaming W1^T tiles [256 f][16 k] (16 KB); + b1 and
//     GELU in f32 into the chunk buffer h [32, 256] (32 KB); stage 2 adds
//     h . W2[chunk, :] into the [32, 768] accumulator, [8, 12] per thread
//     (rows_f32.cuh), streaming W2^T tiles [768 h][8 f] (24 KB);
//   - both streams go through one ring of 3 slots of 24 KB filled by
//     cp.async, one __syncthreads per tile; every block reads the same
//     tiles in the same order, so W1 and W2 (18.9 MB) come from L2;
//   - epilogue from registers: + b2 + x, LN2 (rows_f32.cuh), f32 store of
//     the valid rows.
// 8 rows of reuse per loaded A value and 4 or 12 columns per loaded weight
// float4 keep the shared-memory traffic under the FFMA rate. 32 rows per
// block means each weight byte does 16 flops, so at the full f32 rate the
// blocks read about 4 TB/s of weights from L2; the kernel runs well below
// that rate.
// Split-F path for few rows: when the 32-row tiles would fill fewer blocks
// than the card has SMs, the launch adds a grid dimension of S slices of the
// F chunks (kernels/ffn.py::ffn_plan_f32). Each block then stores its f32
// partial of h . W2 for the valid rows into a scratch buffer [S, M, 768], and
// split_reduce_f32 sums the S partials in slice order, adds b2 and x (LN0
// recomputed for K1, by the same code) and applies LN2. No atomics: the
// result is the same bits on every launch.
// The weights are read in the layout of torch.nn.Linear ([out, in],
// row-major): W1^T [F, 768] and W2^T [768, F], so an nn.Linear weight needs
// no copy.

#include "common.cuh"
#include "rows_f32.cuh"

namespace {

constexpr int kFC = 256;                        // F chunk
constexpr int kS1K = 16;                        // k columns of a W1^T tile
constexpr int kS1Tiles = kF32H / kS1K;          // 48 per chunk
constexpr int kS2Tiles = kFC / kOutTileK;       // 32 per chunk
constexpr int kTilesPerChunk = kS1Tiles + kS2Tiles;
constexpr int kS1Cols = 4;                      // chunk columns per thread
constexpr int kS1TileFloats = kFC * kS1K;       // 16 KB
constexpr int kSlotFloats = kOutTileFloats > kS1TileFloats ? kOutTileFloats : kS1TileFloats;

// shared memory: the x tile, the GELU chunk, the ring, the LN exchange
constexpr int kOffX = 0;
constexpr int kOffH = kOffX + kF32TM * kF32H;
constexpr int kOffRing = kOffH + kF32TM * kFC;
constexpr int kOffRed = kOffRing + kF32Stages * kSlotFloats;
constexpr int kSmemFloats = kOffRed + 2 * kF32ColGroups * kF32TM;
constexpr int kSmemBytes = kSmemFloats * 4;

static_assert(kFC == 2 * 32 * kS1Cols, "two column groups of 4 x 32 chunk columns");
static_assert(kS1TileFloats / 4 % kF32Threads == 0, "whole W1 tile pieces per thread");
static_assert(kSmemBytes <= 232448, "over the per-block shared memory");

// W1^T tile: rows f0 .. f0 + 256 (one chunk), k columns k0 .. k0 + 16,
// [256][16] f32; float4 j of row f stored at position j ^ ((f >> 1) & 3)
__device__ __forceinline__ void load_w1_tile(float* tile, const float* __restrict__ w1t,
                                             long long f0, int k0) {
#pragma unroll
  for (int i = 0; i < kS1TileFloats / 4 / kF32Threads; ++i) {
    const int q = threadIdx.x + kF32Threads * i;
    const int f = q >> 2, j = q & 3;
    mrd::cp_async16(tile + f * kS1K + 4 * (j ^ ((f >> 1) & 3)),
                    w1t + (f0 + f) * kF32H + k0 + 4 * j);
  }
}

// p[r][i] += sum_{k < 16} x[8 rg + r][k0 + k] * W1^T[f_i][k0 + k], f_i =
// 128 (warp / 4) + lane + 32 i within the chunk; k in order, one FFMA per
// term.
__device__ __forceinline__ void w1_tile_step(float (&p)[kF32RowsPerWarp][kS1Cols],
                                             const float* xs, int k0, const float* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xrow = xs + (kF32RowsPerWarp * (warp % 4)) * kF32H + k0;
  const float* wrow = tile + (kFC / 2 * (warp / 4) + lane) * kS1K;
  const int sw = (lane >> 1) & 3;  // (f >> 1) & 3 for every f of this lane
#pragma unroll
  for (int j = 0; j < kS1K / 4; ++j) {
    float4 w[kS1Cols];
#pragma unroll
    for (int i = 0; i < kS1Cols; ++i)
      w[i] = *reinterpret_cast<const float4*>(wrow + 32 * i * kS1K + 4 * (j ^ sw));
#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(xrow + r * kF32H + 4 * j);
#pragma unroll
      for (int i = 0; i < kS1Cols; ++i) {
        float s = p[r][i];
        s = fmaf(a.x, w[i].x, s);
        s = fmaf(a.y, w[i].y, s);
        s = fmaf(a.z, w[i].z, s);
        s = fmaf(a.w, w[i].w, s);
        p[r][i] = s;
      }
    }
  }
}

// Grid: (32-row tiles, slices of F). With one slice the block applies LN2
// and writes y; with several it writes its f32 partial of h . W2 to
// `partial` [slices, M, 768] and split_reduce_f32 finishes the rows.
template <bool kInputLN>
__global__ void __launch_bounds__(kF32Threads, 1)
ffn_ln_f32_kernel(const float* __restrict__ z,      // [M, 768]
                  const float* __restrict__ w1t,    // W1^T [F, 768]
                  const float* __restrict__ b1,     // [F]
                  const float* __restrict__ w2t,    // W2^T [768, F]
                  const float* __restrict__ b2,     // [768]
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta,
                  const float* __restrict__ g0,     // LN0 scale [768] (K1)
                  const float* __restrict__ o0,     // LN0 bias [768] (K1)
                  float* __restrict__ y,            // [M, 768]
                  float* __restrict__ partial,      // [slices, M, 768]
                  int M, int F, int chunks_per_slice, float eps) {
  extern __shared__ __align__(16) float smem_f32[];
  float* xs = smem_f32 + kOffX;
  float* hs = smem_f32 + kOffH;
  float* ring = smem_f32 + kOffRing;
  const long long row0 = static_cast<long long>(blockIdx.x) * kF32TM;
  const int c_begin = blockIdx.y * chunks_per_slice;
  const int n_tiles = chunks_per_slice * kTilesPerChunk;

  // tile g of the slice: W1^T tiles 0 .. 47 of a chunk, then W2^T tiles
  const auto issue = [&](int g, float* slot) {
    const int c = c_begin + g / kTilesPerChunk, u = g % kTilesPerChunk;
    if (u < kS1Tiles)
      load_w1_tile(slot, w1t, static_cast<long long>(c) * kFC, kS1K * u);
    else
      load_out_tile(slot, w2t, F, static_cast<long long>(c) * kFC + kOutTileK * (u - kS1Tiles));
  };
  ring_start(ring, kSlotFloats, n_tiles, issue);
  stage_rows_f32<kInputLN>(xs, z, row0, M, g0, o0, eps);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = kF32RowsPerWarp * (warp % 4);
  float acc[kF32RowsPerWarp][kF32Cols];
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kF32Cols; ++i) acc[r][i] = 0.0f;

  int g = 0;
#pragma unroll 1
  for (int k = 0; k < chunks_per_slice; ++k) {
    const int c = c_begin + k;
    // ---- stage 1: h = GELU(x . W1[:, chunk] + b1)
    float p[kF32RowsPerWarp][kS1Cols];
#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r)
#pragma unroll
      for (int i = 0; i < kS1Cols; ++i) p[r][i] = 0.0f;
#pragma unroll 1
    for (int u = 0; u < kS1Tiles; ++u, ++g)
      w1_tile_step(p, xs, kS1K * u, ring_advance(ring, kSlotFloats, g, n_tiles, issue));
    // the previous chunk's stage 2 read hs before this chunk's last
    // ring_advance (a __syncthreads); stage 2 reads it after the next one
#pragma unroll
    for (int i = 0; i < kS1Cols; ++i) {
      const int col = kFC / 2 * (warp / 4) + lane + 32 * i;
      const float bb = b1[static_cast<long long>(c) * kFC + col];
#pragma unroll
      for (int r = 0; r < kF32RowsPerWarp; ++r) {
        const float v = p[r][i] + bb;
        hs[(rg + r) * kFC + col] = 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
      }
    }
    // ---- stage 2: acc += h . W2[chunk, :]
#pragma unroll 1
    for (int u = 0; u < kS2Tiles; ++u, ++g)
      out_tile_step(acc, hs, kFC, kOutTileK * u,
                    ring_advance(ring, kSlotFloats, g, n_tiles, issue));
  }

  float* red = smem_f32 + kOffRed;
  if (gridDim.y > 1) {  // split-F: the f32 partial of the valid rows
    const int c0 = kF32H / kF32ColGroups * (warp / 4) + lane;
#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) {
      const long long gr = row0 + rg + r;
      if (gr < M) {
        float* dst = partial + (static_cast<long long>(blockIdx.y) * M + gr) * kF32H;
#pragma unroll
        for (int i = 0; i < kF32Cols; ++i) dst[c0 + 32 * i] = acc[r][i];
      }
    }
    return;
  }
  ln_epilogue_f32(acc, xs, nullptr, b2, gamma, beta, red, y, row0, M, eps);
}

// The split path's second pass: y = LN2(sum_s partial[s] + b2 + x), the
// slices summed in order 0 .. S-1, x from load_row_f32 (LN0 of z for K1).
// One warp per row, 8 rows per block.
template <bool kInputLN>
__global__ void __launch_bounds__(256)
split_reduce_f32(const float* __restrict__ partial, int slices, const float* __restrict__ z,
                 const float* __restrict__ b2, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ g0,
                 const float* __restrict__ o0, float* __restrict__ y, int M, float eps) {
  const int lane = threadIdx.x % 32;
  const long long gr = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (gr >= M) return;
  float4 v[kF32RowVecs];
  load_row_f32<kInputLN>(z, gr, M, g0, o0, eps, lane, v);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kF32RowVecs; ++j) {
    const int c = 4 * (lane + 32 * j);
    float4 acc = *reinterpret_cast<const float4*>(partial + gr * kF32H + c);
    for (int sl = 1; sl < slices; ++sl) {
      const float4 a = *reinterpret_cast<const float4*>(
          partial + (sl * static_cast<long long>(M) + gr) * kF32H + c);
      acc = make_float4(acc.x + a.x, acc.y + a.y, acc.z + a.z, acc.w + a.w);
    }
    const float4 b = *reinterpret_cast<const float4*>(b2 + c);
    v[j] = make_float4(acc.x + b.x + v[j].x, acc.y + b.y + v[j].y, acc.z + b.z + v[j].z,
                       acc.w + b.w + v[j].w);
    s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
  }
  const float mu = mrd::warp_sum(s) * (1.0f / kF32H);
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < kF32RowVecs; ++j) {
    const float4 d = make_float4(v[j].x - mu, v[j].y - mu, v[j].z - mu, v[j].w - mu);
    q += (d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w);
  }
  const float rstd = rsqrtf(mrd::warp_sum(q) * (1.0f / kF32H) + eps);
#pragma unroll
  for (int j = 0; j < kF32RowVecs; ++j) {
    const int c = 4 * (lane + 32 * j);
    const float4 g = *reinterpret_cast<const float4*>(gamma + c);
    const float4 o = *reinterpret_cast<const float4*>(beta + c);
    *reinterpret_cast<float4*>(y + gr * kF32H + c) =
        make_float4((v[j].x - mu) * rstd * g.x + o.x, (v[j].y - mu) * rstd * g.y + o.y,
                    (v[j].z - mu) * rstd * g.z + o.z, (v[j].w - mu) * rstd * g.w + o.w);
  }
}

template <bool kInputLN>
cudaError_t launch_f32(const float* z, const float* w1t, const float* b1, const float* w2t,
                       const float* b2, const float* gamma, const float* beta, const float* g0,
                       const float* o0, float* y, float* scratch, int M, int F, int slices,
                       float eps, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ffn_ln_f32_kernel<kInputLN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kF32TM - 1) / kF32TM, slices);
  ffn_ln_f32_kernel<kInputLN><<<grid, kF32Threads, kSmemBytes, stream>>>(
      z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y, scratch, M, F, F / kFC / slices, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  split_reduce_f32<kInputLN><<<(M + 7) / 8, 256, 0, stream>>>(scratch, slices, z, b2, gamma,
                                                               beta, g0, o0, y, M, eps);
  return cudaGetLastError();
}

cudaError_t check_args_f32(int F, int slices, const void* scratch) {
  if (F <= 0 || slices < 1 || F % (kFC * slices) != 0) return cudaErrorInvalidValue;
  if (slices > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  return cudaSuccess;
}

const float* f32p(const void* p) { return static_cast<const float*>(p); }

}  // namespace

extern "C" {

// Dynamic shared memory per block of the f32 FFN kernel.
int mrd_ffn_f32_smem_bytes() { return kSmemBytes; }

// K1 in f32: y = LN2(x + GELU(x W1 + b1) W2 + b2), x = LN0(z), on `stream`.
// Pointers are device pointers to f32, 16-byte aligned; z and y are
// [M, 768], w1t is [F, 768] and w2t is [768, F], row-major; the six vectors
// are f32. `slices` > 1 splits F into that many slices (F a multiple of
// 256 * slices) and needs `scratch`, f32 [slices, M, 768]. Returns the
// cudaError_t of the launches (0 on success). Allocates nothing.
int mrd_ffn_pre_ln_f32(const void* z, const void* w1t, const void* b1, const void* w2t,
                       const void* b2, const void* gamma, const void* beta, const void* g0,
                       const void* o0, void* y, void* scratch, int M, int F, int slices,
                       float eps, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t bad = check_args_f32(F, slices, scratch);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  return static_cast<int>(launch_f32<true>(
      f32p(z), f32p(w1t), f32p(b1), f32p(w2t), f32p(b2), f32p(gamma), f32p(beta), f32p(g0),
      f32p(o0), static_cast<float*>(y), static_cast<float*>(scratch), M, F, slices, eps,
      static_cast<cudaStream_t>(stream)));
}

// K2 in f32: y = LN(x + GELU(x W1 + b1) W2 + b2) with x the input rows as
// they are, on `stream`. Arguments as mrd_ffn_pre_ln_f32 without the LN0
// vectors.
int mrd_ffn_ln_f32(const void* x, const void* w1t, const void* b1, const void* w2t,
                   const void* b2, const void* gamma, const void* beta, void* y, void* scratch,
                   int M, int F, int slices, float eps, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const cudaError_t bad = check_args_f32(F, slices, scratch);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  return static_cast<int>(launch_f32<false>(
      f32p(x), f32p(w1t), f32p(b1), f32p(w2t), f32p(b2), f32p(gamma), f32p(beta), nullptr,
      nullptr, static_cast<float*>(y), static_cast<float*>(scratch), M, F, slices, eps,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
