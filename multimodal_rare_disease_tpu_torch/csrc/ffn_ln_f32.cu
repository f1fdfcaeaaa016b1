// K1 and K2 in f32: the post-LN BERT FFN sublayer of a model whose compute
// dtype is float32, written by hand for Hopper (sm_90a). One template,
// `kInputLN`:
//
//   K1 (kInputLN = true):  x = LN0(z)   z: [M, 768] f32, the unnormalized
//                                          attention residual
//   K2 (kInputLN = false): x = z        (the output of K3, attn_out_ln_f32.cu)
//
//   h = GELU(x . W1 + b1)               W1: [768, F] f32, exact-erf GELU
//   y = LN2(x + h . W2 + b2)            W2: [F, 768] f32
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
// f32 limits refuse), but three TF32 products give an f32-accurate one:
// with a = a_hi + a_lo, a_hi = tf32(a), a_lo = a - a_hi (exact in f32),
//   a . b ~ a_hi . b_hi + a_hi . b_lo + a_lo . b_hi
// (the dropped a_lo . b_lo is 2^-22 of the product). Three passes at the
// 495 TFLOP/s dense TF32 rate bound a call at 0.94 ms.
//
// Design. A fused f32 kernel does not fit: a [64, 768] f32 x tile alone is
// 192 KB of the 227 KB of shared memory a block may take. Sending h through
// device memory costs 0.24 ms at M = 16,384 (h's two TF32 planes, 402 MB,
// written and read at 3.35 TB/s) against the 0.94-ms bound, so one call is
// a sequence of launches on the caller's stream:
//   1. split_operands: x = LN0(z) (K1) or z (K2), by load_row_f32, as the
//      TF32 planes x_hi, x_lo [M, 768]; and W1^T, W2^T (nn.Linear's [out,
//      in] layout, read as they are) as w_hi, w_lo planes. Every call splits
//      the weights anew (56.6 MB of traffic, ~0.02 ms): nothing is cached,
//      so nothing goes stale after a train step;
//   2. gemm_tf32x3<kGelu>: h = GELU(x . W1 + b1), stored as its planes
//      h_hi, h_lo [M, F];
//   3. gemm_tf32x3<kPartial>: h . W2 into f32 partials [S, M, 768], S
//      slices of F's k loop when the output tiles would leave SMs idle
//      (kernels/ffn.py::ffn_plan_f32);
//   4. split_reduce_f32: y = LN2(sum of the S partials in slice order + b2
//      + x), x again by load_row_f32 (LN0 of z for K1): the bits stage 1
//      split. No atomics: the same bits on every launch.
// The GEMM: C[128 rows, 128 cols] per block; both operands K-major (x and
// h row-major, W1^T and W2^T in nn.Linear's layout), so wgmma reads them
// without a transpose. One producer thread streams k-tiles of 32 (128-byte
// rows in TMA's 128-byte swizzle) of A_hi, A_lo, B_hi and B_lo, 64 KB per
// stage, through a ring of 3 stages with full (TMA bytes) and empty (one
// arrival per consumer warp) mbarriers. Two consumer warpgroups of 64 rows
// each run, per k8 step, wgmma m64n128k8 A_hi . B_hi into one accumulator
// and A_hi . B_lo, A_lo . B_hi into a second one, so the small terms are
// not rounded against the large sum at every step. The tensor cores' f32
// sums drift with the length of the k loop (on the H100, K = 3,072 in one
// accumulator read 3.5e-6 mean off the plain version, 8 k-tiles 1.0e-6),
// so every window of 8 k-tiles (K = 256) both accumulators are added to
// a third on the CUDA cores, rounded to nearest, and restarted: one drain
// of the wgmma pipeline per window. Every operand is a plane of exact TF32
// values (low 13 bits zero), so how the tensor core treats the bits it
// ignores does not matter. Rows past M read as zeros (TMA) and are not
// stored.

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"
#include "rows.cuh"
#include "rows_f32.cuh"

namespace {

using mrd::fence_barrier_init;
using mrd::mbar_arrive;
using mrd::mbar_arrive_expect_tx;
using mrd::mbar_init;
using mrd::mbar_wait;
using mrd::opaque;
using mrd::Ring;
using mrd::smem_addr;
using mrd::sw128_desc;
using mrd::tf32_rna;
using mrd::tma_load_2d;

constexpr int kBM = 128;                   // rows per block: two warpgroups of 64
constexpr int kBN = 128;                   // output columns per block (wgmma N)
constexpr int kBK = 32;                    // k per stage: 32 f32, a 128-byte row
constexpr int kStages = 3;
constexpr int kWindow = 8;                 // k-tiles the tensor cores sum alone
constexpr int kWG = 2;                     // consumer warpgroups; the producer is 2
constexpr int kThreads = 128 * (kWG + 1);
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kSplitThreads = 256;         // split_operands and split_reduce_f32
constexpr int kSplitVecs = 4;              // weight float4s per thread of split_operands

// shared memory, from a 1024-byte aligned base: per stage the A_hi, A_lo
// (rows) and B_hi, B_lo (output columns) tiles, [128][32] f32 each; then the
// barriers
constexpr uint32_t kTileBytes = 128 * kBK * 4;      // 16 KB
constexpr uint32_t kStageBytes = 4 * kTileBytes;    // 64 KB
constexpr uint32_t kBarFull = kStages * kStageBytes;
constexpr uint32_t kBarEmpty = kBarFull + 8 * kStages;
constexpr uint32_t kSmemBytes = kBarEmpty + 8 * kStages + 1024;

static_assert(kBM == 128 && kBN == 128, "A and B tiles share one box shape");
static_assert(kBK * 4 == 128, "a k-tile row is one 128-byte swizzle row");
static_assert(kTileBytes % 1024 == 0, "1024-byte swizzle atoms");
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs == kThreads * 168,
              "setmaxnreg must hand over exactly the registers it frees");
static_assert(kSmemBytes <= 232448, "over the per-block shared memory");
static_assert(kF32H == kRowH && kF32H % kBN == 0 && kF32H % kBK == 0,
              "the header's width, whole tiles");

enum Epilogue { kGelu, kPartial };

// The operand planes of `v`: hi = tf32(v), lo = v - hi (exact)
__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
  lo = make_float4(v.x - hi.x, v.y - hi.y, v.z - hi.z, v.w - hi.w);
}

// Stage 1. Blocks [0, row_blocks): one warp per row, x = LN0(z) (K1) or z
// (K2) into x_hi, x_lo [M, 768]. The blocks after them: the weights, W1^T
// [F, 768] then W2^T [768, F], float4 by float4 into their planes.
template <bool kInputLN>
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
    float4 v[kF32RowVecs];
    load_row_f32<kInputLN>(z, gr, M, g0, o0, eps, lane, v);
#pragma unroll
    for (int j = 0; j < kF32RowVecs; ++j) {
      float4 hi, lo;
      split4(v[j], hi, lo);
      const long long at = gr * kF32H + 4 * (lane + 32 * j);
      *reinterpret_cast<float4*>(x_hi + at) = hi;
      *reinterpret_cast<float4*>(x_lo + at) = lo;
    }
    return;
  }
  const long long per = static_cast<long long>(F) * kF32H / 4;  // float4s per matrix
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

// The producer thread: k-tiles k_begin .. k_begin + n_k of the A planes
// (rows row0 ..) and the B planes (output columns col0 ..), one stage each.
__device__ __forceinline__ void produce(const CUtensorMap* a_hi, const CUtensorMap* a_lo,
                                        const CUtensorMap* b_hi, const CUtensorMap* b_lo,
                                        uint32_t base, int row0, int col0, int k_begin,
                                        int n_k) {
  Ring ring;
  for (int t = 0; t < n_k; ++t) {
    mbar_wait(base + kBarEmpty + 8 * ring.slot, ring.phase ^ 1);
    const uint32_t full = base + kBarFull + 8 * ring.slot;
    const uint32_t dst = base + ring.slot * kStageBytes;
    const int k0 = (k_begin + t) * kBK;
    mbar_arrive_expect_tx(full, kStageBytes);
    tma_load_2d(dst, a_hi, full, k0, row0);
    tma_load_2d(dst + kTileBytes, a_lo, full, k0, row0);
    tma_load_2d(dst + 2 * kTileBytes, b_hi, full, k0, col0);
    tma_load_2d(dst + 3 * kTileBytes, b_lo, full, k0, col0);
    ring.next<kStages>();
  }
}

// Consumer wg's share of one k-tile: for each of its 4 k8 steps,
// big += A_hi . B_hi and small += A_hi . B_lo + A_lo . B_hi, on its 64 rows
// of the stage's A tiles. After the group is issued the previous one is
// retired and its stage released (one arrival per warp). kFirst: the first
// k-tile of a window, whose first step writes the accumulators without
// reading them (no group is in flight before it).
template <bool kFirst>
__device__ __forceinline__ void consume(float (&big)[64], float (&small)[64], Ring& ring,
                                        uint32_t& prev, uint32_t base, int wg, bool signal) {
  mbar_wait(base + kBarFull + 8 * ring.slot, ring.phase);
  const uint32_t st = opaque(base) + ring.slot * kStageBytes;
  const uint32_t a_hi = st + wg * (kTileBytes / 2), a_lo = a_hi + kTileBytes;
  const uint32_t b_hi = st + 2 * kTileBytes, b_lo = st + 3 * kTileBytes;
  mrd::fence_operand(big);
  mrd::fence_operand(small);
  mrd::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
    const uint64_t dah = sw128_desc(a_hi + kk * 32), dal = sw128_desc(a_lo + kk * 32);
    const uint64_t dbh = sw128_desc(b_hi + kk * 32), dbl = sw128_desc(b_lo + kk * 32);
    if (kFirst && kk == 0) {
      mrd::wgmma_m64n128k8_tf32_first(big, dah, dbh);
      mrd::wgmma_m64n128k8_tf32_first(small, dah, dbl);
    } else {
      mrd::wgmma_m64n128k8_tf32(big, dah, dbh, 1);
      mrd::wgmma_m64n128k8_tf32(small, dah, dbl, 1);
    }
    mrd::wgmma_m64n128k8_tf32(small, dal, dbh, 1);
  }
  mrd::wgmma_commit();
  mrd::fence_operand(big);
  mrd::fence_operand(small);
  if (!kFirst) {
    mrd::wgmma_wait<1>();
    if (signal) mbar_arrive(base + kBarEmpty + 8 * prev);
  }
  prev = ring.slot;
  ring.next<kStages>();
}

// C = A . B^T over k-tiles blockIdx.z * k_per_slice .. + k_per_slice, A the
// planes of [M, K] (rows blockIdx.y * 128 ..), B the planes of [N, K]
// (output columns blockIdx.x * 128 ..). kGelu: out = GELU(C + bias) as the
// planes out_hi, out_lo [M, N]. kPartial: out_hi[blockIdx.z] [M, N] = C.
template <Epilogue kEpi>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3(const __grid_constant__ CUtensorMap a_hi_map,
            const __grid_constant__ CUtensorMap a_lo_map,
            const __grid_constant__ CUtensorMap b_hi_map,
            const __grid_constant__ CUtensorMap b_lo_map,
            const float* __restrict__ bias,   // [N] (kGelu)
            float* __restrict__ out_hi,       // [M, N], or [slices, M, N]
            float* __restrict__ out_lo,       // [M, N] (kGelu)
            int M, int N, int k_per_slice) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int col0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(base + kBarFull + 8 * s, 1);
      mbar_init(base + kBarEmpty + 8 * s, kWG * 4);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x / 128 == kWG) {
    // ---- the producer warpgroup: one thread issues every TMA load
    mrd::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kWG)
      produce(&a_hi_map, &a_lo_map, &b_hi_map, &b_lo_map, base, row0, col0,
              blockIdx.z * k_per_slice, k_per_slice);
    return;
  }
  // ---- consumer wg: rows row0 + 64 wg .. + 64 of C, in windows of
  // kWindow k-tiles: the tensor cores sum a window into big and small,
  // which are then added to `total` on the CUDA cores (rounded to
  // nearest) and restarted
  mrd::setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const bool signal = lane == 0;
  float big[64], small[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) total[i] = 0.0f;
  Ring ring;
  uint32_t prev = 0;
  for (int t0 = 0; t0 < k_per_slice; t0 += kWindow) {
    const int t1 = min(t0 + kWindow, k_per_slice);
    consume<true>(big, small, ring, prev, base, wg, signal);
    for (int t = t0 + 1; t < t1; ++t) consume<false>(big, small, ring, prev, base, wg, signal);
    mrd::wgmma_wait<0>();
    mrd::fence_operand(big);
    mrd::fence_operand(small);
    if (signal) mbar_arrive(base + kBarEmpty + 8 * prev);
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] += big[i] + small[i];
  }

  // ---- epilogue. Thread (warp, lane) holds rows wrow and wrow + 8 and, per
  // n8 block nb, the columns 8 nb + 2 (lane % 4) and + 1: total[4 nb + 2
  // half + e] is (wrow + 8 half, col + e)
  const int wrow = row0 + 64 * wg + 16 * (warp % 4) + lane / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long gr = wrow + 8 * half;
    if (gr >= M) continue;
    if constexpr (kEpi == kGelu) {
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb) {
        const int col = col0 + 8 * nb + 2 * (lane % 4);
        const float2 b = *reinterpret_cast<const float2*>(bias + col);
        const int i = 4 * nb + 2 * half;
        const float v0 = total[i] + b.x;
        const float v1 = total[i + 1] + b.y;
        const float g0 = 0.5f * v0 * (1.0f + erff(v0 * 0.70710678118654752f));
        const float g1 = 0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f));
        const float h0 = tf32_rna(g0), h1 = tf32_rna(g1);
        *reinterpret_cast<float2*>(out_hi + gr * N + col) = make_float2(h0, h1);
        *reinterpret_cast<float2*>(out_lo + gr * N + col) = make_float2(g0 - h0, g1 - h1);
      }
    } else {
      float* dst = out_hi + (static_cast<long long>(blockIdx.z) * M + gr) * N;
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb) {
        const int col = col0 + 8 * nb + 2 * (lane % 4);
        const int i = 4 * nb + 2 * half;
        *reinterpret_cast<float2*>(dst + col) =
            make_float2(total[i], total[i + 1]);
      }
    }
  }
}

// Stage 4: y = LN2(sum_s partial[s] + b2 + x), the slices summed in order
// 0 .. S-1, x from load_row_f32 (LN0 of z for K1). One warp per row, 8 rows
// per block.
template <bool kInputLN>
__global__ void __launch_bounds__(kSplitThreads)
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

// The scratch buffer of one call, carved in this order (f32 elements; every
// piece a multiple of 768 floats, so 16-byte aligned as TMA needs)
struct Scratch {
  float *x_hi, *x_lo, *w1_hi, *w1_lo, *w2_hi, *w2_lo, *h_hi, *h_lo, *partial;
  Scratch(float* p, long long M, long long F) {
    const long long x = M * kF32H, w = F * kF32H, h = M * F;
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

template <Epilogue kEpi>
cudaError_t launch_gemm(const float* a_hi, const float* a_lo, const float* b_hi,
                        const float* b_lo, const float* bias, float* out_hi, float* out_lo,
                        int M, int N, int K, int slices, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!make_map_f32(&maps[0], a_hi, M, K, kBM) || !make_map_f32(&maps[1], a_lo, M, K, kBM) ||
      !make_map_f32(&maps[2], b_hi, N, K, kBN) || !make_map_f32(&maps[3], b_lo, N, K, kBN))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_tf32x3<kEpi>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM, slices);
  gemm_tf32x3<kEpi><<<grid, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias, out_hi, out_lo, M, N, K / kBK / slices);
  return cudaGetLastError();
}

template <bool kInputLN>
cudaError_t launch_f32(const float* z, const float* w1t, const float* b1, const float* w2t,
                       const float* b2, const float* gamma, const float* beta, const float* g0,
                       const float* o0, float* y, float* scratch, int M, int F, int slices,
                       float eps, cudaStream_t stream) {
  const Scratch s(scratch, M, F);
  const int row_blocks = (M + kSplitThreads / 32 - 1) / (kSplitThreads / 32);
  const long long w_vecs = 2LL * F * kF32H / 4;
  const int w_blocks = static_cast<int>((w_vecs + kSplitThreads * kSplitVecs - 1) /
                                        (kSplitThreads * kSplitVecs));
  split_operands<kInputLN><<<row_blocks + w_blocks, kSplitThreads, 0, stream>>>(
      z, g0, o0, s.x_hi, s.x_lo, w1t, w2t, s.w1_hi, s.w1_lo, s.w2_hi, s.w2_lo, M, F,
      row_blocks, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_gemm<kGelu>(s.x_hi, s.x_lo, s.w1_hi, s.w1_lo, b1, s.h_hi, s.h_lo, M, F, kF32H,
                           1, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<kPartial>(s.h_hi, s.h_lo, s.w2_hi, s.w2_lo, nullptr, s.partial, nullptr,
                              M, kF32H, F, slices, stream);
  if (err != cudaSuccess) return err;
  split_reduce_f32<kInputLN><<<(M + 7) / 8, kSplitThreads, 0, stream>>>(
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
