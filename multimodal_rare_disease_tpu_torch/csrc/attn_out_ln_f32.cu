// K3 in f32: the post-LN BERT attention-output sublayer of a model whose
// compute dtype is float32, written by hand for Hopper (sm_90a):
//
//   y = LN(x + ctx . Wo^T + bo)   ctx, x: [M, H] f32; Wo: [H, H] f32 in
//                                 torch.nn.Linear's [out, in]
//
// H is a template parameter, built for 768 (BERT-base), 1,024 (BERT-large),
// 512, 256 and 128 (the compact BERTs), 384 (MiniLM), 640 and 896, and
// 1,152, 1,280, 1,408 and 1,536: H / 128 column tiles of the GEMM (6, 8,
// 4, 2, 1, 3, 5, 7, 9, 10, 11, 12) and H / 32 k-tiles (24, 32, 16, 8, 4,
// 12, 20, 28, 36, 40, 44, 48).
//
// The function is the Pallas body run in f32
// (multimodal_rare_disease_tpu/ops/pallas/attn_out.py:38-47): an
// f32-accurate product, bo and the residual added in f32, then the two-pass
// LayerNorm (eps given, 1e-12 for BERT). bo, gamma and beta are f32.
//
// Replaces multimodal_rare_disease_tpu/ops/pallas/attn_out.py::
// _attn_out_ln_kernel (reached through _fused_attn_out_ln_impl) where the
// JAX model runs it in f32 (training.compute_dtype=float32); attn_out_ln.cu
// is its bf16 form.
//
// What bounds it on the H100: the operations. At the packed batch of 256
// documents (M = 16,384) one call does 2*M*768*768 = 19.3 GFLOP against
// 153 MB of device memory (ctx, x and y, 50 MB each, and Wo, 2.4 MB): 0.046
// ms at 3.35 TB/s. On the CUDA cores the product alone takes 0.29 ms at the
// 67 TFLOP/s f32 rate; as three TF32 products on the tensor cores (the
// f32-accurate split of gemm_tf32x3.cuh) it is bounded at 0.117 ms by the
// 495 TFLOP/s TF32 rate.
//
// Design: gemm_tf32x3.cuh's GEMM, which K1-f32 and K2-f32 run, with A split
// on the chip. One call is three launches on the caller's stream:
//   1. split_weight: Wo^T [H out, H in] into its exact TF32 planes
//      (2.4 MB read, 4.7 MB written). Every call splits it anew: nothing is
//      cached, so nothing goes stale after a train step;
//   2. gemm_tf32x3<kPartial, kSplitA>: ctx . Wo^T into f32 partials
//      [S, M, H], H / 128 column tiles x ceil(M / 128) row tiles, the k loop
//      of H / 32 k-tiles in S slices of at least 8 when the output tiles would
//      leave SMs idle (kernels/attn_out.py::attn_out_plan_f32; S = 1 at the
//      packed batch, 3 at a single request's 64 rows). ctx is read from
//      device memory once, as f32, by TMA, and each consumer warpgroup
//      splits its 64 rows into the TF32 planes in shared memory (kSplitA).
//      A pass that wrote ctx's planes to device memory and read them back
//      would move 250 MB at M = 16,384 (0.075 ms at 3.35 TB/s against the
//      0.117-ms bound). wgmma could instead take A from registers, split
//      there, but the operand fragments (two planes of 4 k8 steps) would
//      stay live beside the 192 accumulator floats of the consumers' 232
//      registers; the split in shared memory keeps no register across the
//      product;
//   3. split_reduce_f32<false>: y = LN(sum of the S partials in slice order
//      + bo + x). No atomics: the same bits on every launch.
// At H = 128-640 a call with `slices` 0 (kernels/attn_out.py::
// f32_rows_form: where it is faster, the packed batch among them) is two
// launches instead: split_weight, then attn_out_rows_f32.cuh's one pass over
// whole rows (the LayerNorm in the product's epilogue, no partials), whose
// pre-LayerNorm sums are step 2's and 3's bit for bit.
// Rows past M read as zeros (TMA) and are not stored. Numerics: the 3xTF32
// products of K1-f32 (on the H100, within 2.4e-6-2.0e-5 max and 5.2e-7-
// 9.0e-7 mean of the plain f32 version for K1-f32); the sums of each window
// of 8 k-tiles go into a register total on the CUDA cores.

#include <cuda.h>

#include "common.cuh"
#include "attn_out_rows_f32.cuh"
#include "gemm_tf32x3.cuh"

namespace {

// Stage 1: Wo^T [kH, kH] into its planes w_hi, w_lo, float4 by float4
template <int kH>
__global__ void __launch_bounds__(kSplitThreads)
split_weight(const float* __restrict__ wot, float* __restrict__ w_hi,
             float* __restrict__ w_lo) {
  constexpr long long kWoVecs = static_cast<long long>(kH) * kH / 4;
  const long long first =
      static_cast<long long>(blockIdx.x) * kSplitThreads * kSplitVecs + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kSplitVecs; ++i) {
    const long long q = first + i * kSplitThreads;
    if (q >= kWoVecs) return;
    float4 hi, lo;
    split4(reinterpret_cast<const float4*>(wot)[q], hi, lo);
    reinterpret_cast<float4*>(w_hi)[q] = hi;
    reinterpret_cast<float4*>(w_lo)[q] = lo;
  }
}

template <int kH>
int attn_out_ln_f32(const void* ctx, const void* x, const void* wo, const void* bo,
                    const void* gamma, const void* beta, void* y, void* scratch, int M,
                    int slices, float eps, void* stream) {
  static_assert(kWholeTiles<kH>, "whole tiles");
  constexpr int kK = kH;  // Wo^T's k
  constexpr long long kWoVecs = static_cast<long long>(kH) * kK / 4;
  constexpr int kWoBlocks = static_cast<int>(
      (kWoVecs + kSplitThreads * kSplitVecs - 1) / (kSplitThreads * kSplitVecs));
  if (M <= 0) return static_cast<int>(cudaSuccess);
  if (slices < (kH <= 640 ? 0 : 1) || (slices > 0 && (kK / kBK) % slices != 0) ||
      scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w_hi = static_cast<float*>(scratch);
  float* w_lo = w_hi + kH * kK;
  float* partial = w_lo + kH * kK;
  split_weight<kH><<<kWoBlocks, kSplitThreads, 0, s>>>(f(wo), w_hi, w_lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kH <= 640) {
    if (slices == 0) {
      err = launch_rows<kH>(f(ctx), f(x), w_hi, w_lo, f(bo), f(gamma), f(beta),
                            static_cast<float*>(y), M, eps, s);
      return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
    }
  }
  err = launch_gemm<kPartial, true>(f(ctx), nullptr, w_hi, w_lo, nullptr, partial, nullptr, M,
                                    kH, kK, slices, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_reduce_f32<kH, false><<<(M + 7) / 8, kSplitThreads, 0, s>>>(
      partial, slices, f(x), f(bo), f(gamma), f(beta), nullptr, nullptr,
      static_cast<float*>(y), M, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory per block of the f32 attention-output GEMM.
int mrd_attn_out_f32_smem_bytes() { return static_cast<int>(kSmemBytes); }

// y = LN(x + ctx Wo^T + bo) in f32 on `stream`. Pointers are device pointers
// to f32, 16-byte aligned; ctx, x and y are [M, 768] row-major, wo is
// [768 out, 768 in] row-major, bo, gamma and beta are [768]. `slices` (1, 2
// or 3: a divisor of the 24 k-tiles) splits the product's k loop. `scratch`
// holds f32 2 768 768 + slices M 768 elements
// (kernels/attn_out.py::attn_out_plan_f32): Wo's planes, then the partials.
// Returns the cudaError_t of the launches (0 on success). Allocates nothing.
int mrd_attn_out_ln_f32(const void* ctx, const void* x, const void* wo, const void* bo,
                        const void* gamma, const void* beta, void* y, void* scratch, int M,
                        int slices, float eps, void* stream) {
  return attn_out_ln_f32<768>(ctx, x, wo, bo, gamma, beta, y, scratch, M, slices, eps, stream);
}

// The same at the other built widths H: `name`_h<H>, [M, H] rows, wo [H, H],
// `slices` a divisor of the H / 32 k-tiles, scratch 2 H H + slices M H; at
// H = 128-640 `slices` 0 takes the pass over whole rows, scratch 2 H H.
#define MRD_ATTN_OUT_F32_WIDTH(kH)                                                           \
  int mrd_attn_out_ln_f32_h##kH(const void* ctx, const void* x, const void* wo,              \
                                const void* bo, const void* gamma, const void* beta,         \
                                void* y, void* scratch, int M, int slices, float eps,        \
                                void* stream) {                                              \
    return attn_out_ln_f32<kH>(ctx, x, wo, bo, gamma, beta, y, scratch, M, slices, eps,      \
                               stream);                                                      \
  }

// and at H = 128-640 the clusters of that pass the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 if the runtime cannot say): a launch
// takes as many, at most one per row tile of 128
#define MRD_ATTN_OUT_F32_ROWS(kH)                                                            \
  MRD_ATTN_OUT_F32_WIDTH(kH)                                                                 \
  int mrd_attn_out_f32_clusters_h##kH() { return rows_resident<kH>(); }

MRD_ATTN_OUT_F32_ROWS(128)
MRD_ATTN_OUT_F32_ROWS(256)
MRD_ATTN_OUT_F32_ROWS(384)
MRD_ATTN_OUT_F32_ROWS(512)
MRD_ATTN_OUT_F32_ROWS(640)
MRD_ATTN_OUT_F32_WIDTH(896)
MRD_ATTN_OUT_F32_WIDTH(1024)
MRD_ATTN_OUT_F32_WIDTH(1152)
MRD_ATTN_OUT_F32_WIDTH(1280)
MRD_ATTN_OUT_F32_WIDTH(1408)
MRD_ATTN_OUT_F32_WIDTH(1536)

}  // extern "C"
