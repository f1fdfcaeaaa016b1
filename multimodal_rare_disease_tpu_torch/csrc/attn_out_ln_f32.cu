// K3 in f32: the post-LN BERT attention-output sublayer of a model whose
// compute dtype is float32, written by hand for Hopper (sm_90a):
//
//   y = LN(x + ctx . Wo^T + bo)   ctx, x: [M, 768] f32; Wo: [768, 768] f32 in
//                                 torch.nn.Linear's [out, in]
//
// Everything is f32 as in the Pallas body run in f32
// (multimodal_rare_disease_tpu/ops/pallas/attn_out.py:38-47): operands,
// products and sums are IEEE single precision (FFMA on the CUDA cores, never
// TF32); bo and the residual are added in f32 before the two-pass LayerNorm
// (eps given, 1e-12 for BERT). bo, gamma and beta are f32.
//
// Replaces multimodal_rare_disease_tpu/ops/pallas/attn_out.py::
// _attn_out_ln_kernel (reached through _fused_attn_out_ln_impl) where the
// JAX model runs it in f32 (training.compute_dtype=float32); attn_out_ln.cu
// is its bf16 form.
//
// What bounds it on the H100: the operations. At the packed batch of 256
// documents (M = 16,384) one call does 2*M*768*768 = 19.3 GFLOP, 0.29 ms at
// the 67 TFLOP/s f32 rate, against 153 MB of device memory (ctx, x and y,
// 50 MB each, and Wo, 2.4 MB): 0.046 ms at 3.35 TB/s.
//
// Design: the product of rows_f32.cuh. A block owns 32 rows and 256 threads;
// the ctx tile [32, 768] f32 (96 KB) is staged in shared memory once (zeros
// past M), and Wo^T streams through a ring of 3 tiles [768 out][8 k] (24 KB)
// filled by cp.async, every block reading the same tiles from L2. Each
// thread keeps an [8, 12] slice of the [32, 768] f32 accumulator; the
// epilogue adds bo and x (read from device memory once, by the rows' owners)
// and applies LN from the registers. One call of the packed batch is 512
// blocks, about four waves of 132 SMs; a single request's 64 rows take two
// blocks (0.1 ms of f32 work each), so the kernel has no split path.

#include "common.cuh"
#include "rows_f32.cuh"

namespace {

constexpr int kTiles = kF32H / kOutTileK;  // 96 Wo^T tiles
constexpr int kOffCtx = 0;
constexpr int kOffRing = kOffCtx + kF32TM * kF32H;
constexpr int kOffRed = kOffRing + kF32Stages * kOutTileFloats;
constexpr int kSmemBytes = (kOffRed + 2 * kF32ColGroups * kF32TM) * 4;

static_assert(kSmemBytes <= 232448, "over the per-block shared memory");

__global__ void __launch_bounds__(kF32Threads, 1)
attn_out_ln_f32_kernel(const float* __restrict__ ctx,    // [M, 768]
                       const float* __restrict__ x,      // [M, 768]
                       const float* __restrict__ wot,    // Wo^T [768 out, 768 in]
                       const float* __restrict__ bo,     // [768]
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       float* __restrict__ y,            // [M, 768]
                       int M, float eps) {
  extern __shared__ __align__(16) float smem_f32[];
  float* cs = smem_f32 + kOffCtx;
  float* ring = smem_f32 + kOffRing;
  const long long row0 = static_cast<long long>(blockIdx.x) * kF32TM;
  const auto issue = [&](int g, float* slot) {
    load_out_tile(slot, wot, kF32H, kOutTileK * g);
  };
  ring_start(ring, kOutTileFloats, kTiles, issue);
  stage_rows_f32(cs, ctx, row0, M);

  float acc[kF32RowsPerWarp][kF32Cols];
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kF32Cols; ++i) acc[r][i] = 0.0f;
#pragma unroll 1
  for (int g = 0; g < kTiles; ++g)
    out_tile_step(acc, cs, kF32H, kOutTileK * g,
                  ring_advance(ring, kOutTileFloats, g, kTiles, issue));
  ln_epilogue_f32(acc, x, bo, gamma, beta, smem_f32 + kOffRed, y, row0, M, eps);
}

}  // namespace

extern "C" {

// Dynamic shared memory per block of the f32 attention-output kernel.
int mrd_attn_out_f32_smem_bytes() { return kSmemBytes; }

// y = LN(x + ctx Wo^T + bo) in f32 on `stream`. Pointers are device pointers
// to f32, 16-byte aligned; ctx, x and y are [M, 768] row-major, wo is
// [768 out, 768 in] row-major, bo, gamma and beta are [768]. Returns the
// cudaError_t of the launch (0 on success). Allocates nothing.
int mrd_attn_out_ln_f32(const void* ctx, const void* x, const void* wo, const void* bo,
                        const void* gamma, const void* beta, void* y, int M, float eps,
                        void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err = cudaFuncSetAttribute(attn_out_ln_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_out_ln_f32_kernel<<<(M + kF32TM - 1) / kF32TM, kF32Threads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      f(ctx), f(x), f(wo), f(bo), f(gamma), f(beta), static_cast<float*>(y), M, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
