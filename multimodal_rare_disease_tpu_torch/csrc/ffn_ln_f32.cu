// K1 and K2 in f32: the post-LN BERT FFN sublayer of a model whose compute
// dtype is float32, written by hand for Hopper (sm_90a). One template over
// the hidden width H (built for 768, BERT-base, 1,024, BERT-large, 512,
// 256 and 128, the compact BERTs, 384, MiniLM, 640 and 896, and 1,152,
// 1,280, 1,408 and 1,536) and
// `kInputLN`:
//
//   K1 (kInputLN = true):  x = LN0(z)   z: [M, H] f32, the unnormalized
//                                          attention residual
//   K2 (kInputLN = false): x = z        (the output of K3, attn_out_ln_f32.cu)
//
//   h = GELU(x . W1 + b1)               W1: [H, F] f32, exact-erf GELU
//   y = LN2(x + h . W2 + b2)            W2: [F, H] f32
//
// The function is the Pallas body run in f32
// (multimodal_rare_disease_tpu/ops/pallas/ffn.py:72-133): f32 operands and
// sums, exact-erf GELU in f32, two-pass LayerNorm statistics (eps given,
// 1e-12 for BERT); the six vectors are f32.
//
// Replaces multimodal_rare_disease_tpu/ops/pallas/ffn.py::_ffn_pre_ln_kernel
// (K1, reached through _fused_ffn_pre_ln_impl) and ::_ffn_ln_kernel (K2,
// through _fused_ffn_ln_impl) where the JAX model runs them in f32
// (training.compute_dtype=float32); ffn_ln.cu is their bf16 form.
//
// What bounds it on the H100: the operations. One call is 4*M*768*F flops
// (154.6 GFLOP at M = 16,384 and F = 3,072) against 119.6 MB of device
// memory (x, y, W1, W2). On the CUDA cores that is 2.31 ms at the 67
// TFLOP/s f32 rate. The tensor cores take f32 operands only as TF32 (a
// 10-bit mantissa: 1.7e-3-3.2e-3 off on LayerNorm-scale outputs, which the
// f32 limits refuse), but three TF32 products give an f32-accurate one (the
// split of gemm_tf32x3.cuh). Three passes at the 495 TFLOP/s dense TF32
// rate bound a call at 0.94 ms.
//
// Design. A fused f32 kernel does not fit: a [64, 768] f32 x tile alone is
// 192 KB of the 227 KB of shared memory a block may take. Sending h through
// device memory costs 0.24 ms at M = 16,384 (h's two TF32 planes, 402 MB,
// written and read at 3.35 TB/s) against the 0.94-ms bound, so one call is
// a sequence of launches on the caller's stream:
//   1. split_operands: x = LN0(z) (K1) or z (K2), by load_row_f32, as the
//      TF32 planes x_hi, x_lo [M, H]; and W1^T, W2^T (nn.Linear's [out,
//      in] layout, read as they are) as w_hi, w_lo planes. Every call splits
//      the weights anew (56.6 MB of traffic, ~0.02 ms): nothing is cached,
//      so nothing goes stale after a train step;
//   2. gemm_tf32x3<kGelu>: h = GELU(x . W1 + b1), stored as its planes
//      h_hi, h_lo [M, F];
//   3. gemm_tf32x3<kPartial>: h . W2 into f32 partials [S, M, H], S
//      slices of F's k loop when the output tiles would leave SMs idle
//      (kernels/ffn.py::ffn_plan_f32);
//   4. split_reduce_f32: y = LN2(sum of the S partials in slice order + b2
//      + x), x again by load_row_f32 (LN0 of z for K1): the bits stage 1
//      split. No atomics: the same bits on every launch.
// At H = 128 and 256 a call with `slices` 0 (kernels/ffn.py::f32_rows_form:
// the packed batch) is two launches instead: split_weights_rows (W1^T's
// planes, and W2^T's with F permuted within each group of 8), then
// ffn_rows_f32.cuh's one pass over whole row tiles of 128, which keeps h on
// the chip and writes only y (built by ffn_rows_f32.cu); its scratch is the
// weights' planes, 4 F H floats.
// The GEMM (both products) and the reduce pass are gemm_tf32x3.cuh's, shared
// with attn_out_ln_f32.cu (K3-f32); both operands of each product arrive here
// as planes that stage 1 or the GELU epilogue wrote. The GEMM tiles any
// width by 128-column output tiles and 32-deep k-tiles, so H = 1,024 is the
// same launches with 8 column tiles (6 at 768) and 32 k-tiles in the first
// product; its scratch at M = 16,384 and F = 4,096 is 805 MB per call. H =
// 512, 256 and 128 are the same launches with 4, 2 and 1 column tiles of
// h . W2 and 16, 8 and 4 k-tiles in x . W1 (one window of the register
// total or less); 384, 640 and 896 with 3, 5 and 7 column tiles and 12,
// 20 and 28 k-tiles; 1,152, 1,280, 1,408 and 1,536 with 9, 10, 11 and 12
// column tiles and 36, 40, 44 and 48 k-tiles (at 1,536, F = 6,144 and M =
// 16,384 the scratch is 1.26 GB per call).

#include <cuda.h>

#include "common.cuh"
#include "gemm_tf32x3.cuh"

namespace mrd {
// ffn_rows_f32.cu: the one-pass form at h = 128 or 256 (launch_ffn_rows of
// ffn_rows_f32.cuh)
cudaError_t ffn_rows_launch(int h, bool input_ln, const float* z, const float* w1t,
                            const float* b1, const float* w2t, const float* b2,
                            const float* gamma, const float* beta, const float* g0,
                            const float* o0, float* y, float* scratch, int M, int F, float eps,
                            cudaStream_t stream);
}  // namespace mrd

namespace {

// Stage 1. Blocks [0, row_blocks): one warp per row, x = LN0(z) (K1) or z
// (K2) into x_hi, x_lo [M, kH]. The blocks after them: the weights, W1^T
// [F, kH] then W2^T [kH, F], float4 by float4 into their planes.
template <int kH, bool kInputLN>
__global__ void __launch_bounds__(kSplitThreads)
split_operands(const float* __restrict__ z, const float* __restrict__ g0,
               const float* __restrict__ o0, float* __restrict__ x_hi,
               float* __restrict__ x_lo, const float* __restrict__ w1t,
               const float* __restrict__ w2t, float* __restrict__ w1_hi,
               float* __restrict__ w1_lo, float* __restrict__ w2_hi,
               float* __restrict__ w2_lo, int M, int F, int row_blocks, float eps) {
  const int lane = threadIdx.x % 32;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const long long gr = static_cast<long long>(blockIdx.x) * (kSplitThreads / 32) +
                         threadIdx.x / 32;
    if (gr >= M) return;
    float4 v[kF32RowVecs<kH>];
    load_row_f32<kH, kInputLN>(z, gr, M, g0, o0, eps, lane, v);
#pragma unroll
    for (int j = 0; j < kF32RowVecs<kH>; ++j) {
      float4 hi, lo;
      split4(v[j], hi, lo);
      const long long at = gr * kH + 4 * (lane + 32 * j);
      *reinterpret_cast<float4*>(x_hi + at) = hi;
      *reinterpret_cast<float4*>(x_lo + at) = lo;
    }
    return;
  }
  const long long per = static_cast<long long>(F) * kH / 4;  // float4s per matrix
  const long long first =
      (static_cast<long long>(blockIdx.x) - row_blocks) * kSplitThreads * kSplitVecs +
      threadIdx.x;
#pragma unroll
  for (int i = 0; i < kSplitVecs; ++i) {
    long long q = first + i * kSplitThreads;
    if (q >= 2 * per) return;
    const bool second = q >= per;
    q -= second ? per : 0;
    float4 hi, lo;
    split4(reinterpret_cast<const float4*>(second ? w2t : w1t)[q], hi, lo);
    reinterpret_cast<float4*>(second ? w2_hi : w1_hi)[q] = hi;
    reinterpret_cast<float4*>(second ? w2_lo : w1_lo)[q] = lo;
  }
}

// The scratch buffer of one call, carved in this order (f32 elements; every
// piece a multiple of 128 floats, so 16-byte aligned as TMA needs)
struct Scratch {
  float *x_hi, *x_lo, *w1_hi, *w1_lo, *w2_hi, *w2_lo, *h_hi, *h_lo, *partial;
  Scratch(float* p, long long M, long long F, long long H) {
    const long long x = M * H, w = F * H, h = M * F;
    x_hi = p;
    x_lo = x_hi + x;
    w1_hi = x_lo + x;
    w1_lo = w1_hi + w;
    w2_hi = w1_lo + w;
    w2_lo = w2_hi + w;
    h_hi = w2_lo + w;
    h_lo = h_hi + h;
    partial = h_lo + h;
  }
};

template <int kH, bool kInputLN>
cudaError_t launch_f32(const float* z, const float* w1t, const float* b1, const float* w2t,
                       const float* b2, const float* gamma, const float* beta, const float* g0,
                       const float* o0, float* y, float* scratch, int M, int F, int slices,
                       float eps, cudaStream_t stream) {
  static_assert(kWholeTiles<kH>, "whole tiles");
  const Scratch s(scratch, M, F, kH);
  const int row_blocks = (M + kSplitThreads / 32 - 1) / (kSplitThreads / 32);
  const long long w_vecs = 2LL * F * kH / 4;
  const int w_blocks = static_cast<int>((w_vecs + kSplitThreads * kSplitVecs - 1) /
                                        (kSplitThreads * kSplitVecs));
  split_operands<kH, kInputLN><<<row_blocks + w_blocks, kSplitThreads, 0, stream>>>(
      z, g0, o0, s.x_hi, s.x_lo, w1t, w2t, s.w1_hi, s.w1_lo, s.w2_hi, s.w2_lo, M, F,
      row_blocks, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_gemm<kGelu>(s.x_hi, s.x_lo, s.w1_hi, s.w1_lo, b1, s.h_hi, s.h_lo, M, F, kH, 1,
                           stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<kPartial>(s.h_hi, s.h_lo, s.w2_hi, s.w2_lo, nullptr, s.partial, nullptr,
                              M, kH, F, slices, stream);
  if (err != cudaSuccess) return err;
  split_reduce_f32<kH, kInputLN><<<(M + 7) / 8, kSplitThreads, 0, stream>>>(
      s.partial, slices, z, b2, gamma, beta, g0, o0, y, M, eps);
  return cudaGetLastError();
}

cudaError_t check_args_f32(int F, int slices, const void* scratch) {
  if (F <= 0 || F % kBN != 0 || slices < 1 || (F / kBK) % slices != 0)
    return cudaErrorInvalidValue;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  return cudaSuccess;
}

const float* f32p(const void* p) { return static_cast<const float*>(p); }

// The one-pass form at H = 128 and 256: F a multiple of 128, scratch 4 F kH
// floats
template <int kH, bool kInputLN>
cudaError_t rows_f32(const void* z, const void* w1t, const void* b1, const void* w2t,
                     const void* b2, const void* gamma, const void* beta, const void* g0,
                     const void* o0, void* y, void* scratch, int M, int F, float eps,
                     void* stream) {
  if (F <= 0 || F % kBN != 0 || scratch == nullptr) return cudaErrorInvalidValue;
  return mrd::ffn_rows_launch(kH, kInputLN, f32p(z), f32p(w1t), f32p(b1), f32p(w2t), f32p(b2),
                              f32p(gamma), f32p(beta), f32p(g0), f32p(o0),
                              static_cast<float*>(y), static_cast<float*>(scratch), M, F, eps,
                              static_cast<cudaStream_t>(stream));
}

template <int kH>
int pre_ln_f32(const void* z, const void* w1t, const void* b1, const void* w2t,
               const void* b2, const void* gamma, const void* beta, const void* g0,
               const void* o0, void* y, void* scratch, int M, int F, int slices, float eps,
               void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  if constexpr (kH <= 256) {
    if (slices == 0)
      return static_cast<int>(rows_f32<kH, true>(z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y,
                                                 scratch, M, F, eps, stream));
  }
  const cudaError_t bad = check_args_f32(F, slices, scratch);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  return static_cast<int>(launch_f32<kH, true>(
      f32p(z), f32p(w1t), f32p(b1), f32p(w2t), f32p(b2), f32p(gamma), f32p(beta), f32p(g0),
      f32p(o0), static_cast<float*>(y), static_cast<float*>(scratch), M, F, slices, eps,
      static_cast<cudaStream_t>(stream)));
}

template <int kH>
int ln_f32(const void* x, const void* w1t, const void* b1, const void* w2t, const void* b2,
           const void* gamma, const void* beta, void* y, void* scratch, int M, int F,
           int slices, float eps, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  if constexpr (kH <= 256) {
    if (slices == 0)
      return static_cast<int>(rows_f32<kH, false>(x, w1t, b1, w2t, b2, gamma, beta, nullptr,
                                                  nullptr, y, scratch, M, F, eps, stream));
  }
  const cudaError_t bad = check_args_f32(F, slices, scratch);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  return static_cast<int>(launch_f32<kH, false>(
      f32p(x), f32p(w1t), f32p(b1), f32p(w2t), f32p(b2), f32p(gamma), f32p(beta), nullptr,
      nullptr, static_cast<float*>(y), static_cast<float*>(scratch), M, F, slices, eps,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Dynamic shared memory per block of the f32 FFN's GEMM kernel.
int mrd_ffn_f32_smem_bytes() { return static_cast<int>(kSmemBytes); }

// K1 in f32: y = LN2(x + GELU(x W1 + b1) W2 + b2), x = LN0(z), on `stream`.
// Pointers are device pointers to f32, 16-byte aligned; z and y are
// [M, 768], w1t is [F, 768] and w2t is [768, F], row-major; the six vectors
// are f32. F is a multiple of 128; `slices` (a divisor of F / 32) splits the
// second product's k loop. `scratch` holds f32 2 M 768 + 4 F 768 + 2 M F +
// slices M 768 elements (kernels/ffn.py::ffn_plan_f32). Returns the
// cudaError_t of the launches (0 on success). Allocates nothing.
int mrd_ffn_pre_ln_f32(const void* z, const void* w1t, const void* b1, const void* w2t,
                       const void* b2, const void* gamma, const void* beta, const void* g0,
                       const void* o0, void* y, void* scratch, int M, int F, int slices,
                       float eps, void* stream) {
  return pre_ln_f32<768>(z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y, scratch, M, F, slices,
                         eps, stream);
}

// K2 in f32: y = LN(x + GELU(x W1 + b1) W2 + b2) with x the input rows as
// they are, on `stream`. Arguments as mrd_ffn_pre_ln_f32 without the LN0
// vectors.
int mrd_ffn_ln_f32(const void* x, const void* w1t, const void* b1, const void* w2t,
                   const void* b2, const void* gamma, const void* beta, void* y, void* scratch,
                   int M, int F, int slices, float eps, void* stream) {
  return ln_f32<768>(x, w1t, b1, w2t, b2, gamma, beta, y, scratch, M, F, slices, eps, stream);
}

// K1 and K2 in f32 at the other built widths H: `name`_h<H>, as the two
// above with H in place of 768 (the rows, the weights' H side, the vectors
// but b1, the scratch); at H = 128 and 256 `slices` 0 takes the one-pass
// form, scratch 4 F H.
#define MRD_FFN_F32_WIDTH(kH)                                                                \
  int mrd_ffn_pre_ln_f32_h##kH(const void* z, const void* w1t, const void* b1,               \
                               const void* w2t, const void* b2, const void* gamma,           \
                               const void* beta, const void* g0, const void* o0, void* y,    \
                               void* scratch, int M, int F, int slices, float eps,           \
                               void* stream) {                                               \
    return pre_ln_f32<kH>(z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y, scratch, M, F,        \
                          slices, eps, stream);                                              \
  }                                                                                          \
  int mrd_ffn_ln_f32_h##kH(const void* x, const void* w1t, const void* b1, const void* w2t,  \
                           const void* b2, const void* gamma, const void* beta, void* y,     \
                           void* scratch, int M, int F, int slices, float eps,               \
                           void* stream) {                                                   \
    return ln_f32<kH>(x, w1t, b1, w2t, b2, gamma, beta, y, scratch, M, F, slices, eps,       \
                      stream);                                                               \
  }

MRD_FFN_F32_WIDTH(128)
MRD_FFN_F32_WIDTH(256)
MRD_FFN_F32_WIDTH(384)
MRD_FFN_F32_WIDTH(512)
MRD_FFN_F32_WIDTH(640)
MRD_FFN_F32_WIDTH(896)
MRD_FFN_F32_WIDTH(1024)
MRD_FFN_F32_WIDTH(1152)
MRD_FFN_F32_WIDTH(1280)
MRD_FFN_F32_WIDTH(1408)
MRD_FFN_F32_WIDTH(1536)

}  // extern "C"
