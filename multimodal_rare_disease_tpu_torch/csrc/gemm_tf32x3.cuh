// The f32-accurate GEMM of the port's f32 kernels, written by hand for Hopper
// (sm_90a): ffn_ln_f32.cu (K1-f32 and K2-f32: x . W1 and h . W2) and
// attn_out_ln_f32.cu (K3-f32: ctx . Wo), with the pass that sums its split
// partials into the LayerNorm'd output.
//
// The tensor cores take f32 operands only as TF32 (a 10-bit mantissa), but
// three TF32 products give an f32-accurate one: with a = a_hi + a_lo,
// a_hi = tf32(a), a_lo = a - a_hi (exact in f32),
//   a . b ~ a_hi . b_hi + a_hi . b_lo + a_lo . b_hi
// (the dropped a_lo . b_lo is 2^-22 of the product).
//
// gemm_tf32x3: C[128 rows, 128 cols] per block; both operands K-major (the
// rows row-major, the weights in nn.Linear's [out, in] layout), so wgmma
// reads them without a transpose. One producer thread streams k-tiles of 32
// (128-byte rows in TMA's 128-byte swizzle) of A_hi, A_lo, B_hi and B_lo,
// 64 KB per stage, through a ring of 3 stages with full (TMA bytes) and
// empty (one arrival per consumer warp) mbarriers. Two consumer warpgroups
// of 64 rows each run, per k8 step, wgmma m64n128k8 A_hi . B_hi into one
// accumulator and A_hi . B_lo, A_lo . B_hi into a second one, so the small
// terms are not rounded against the large sum at every step. The tensor
// cores' f32 sums drift with the length of the k loop (on the H100, K =
// 3,072 in one accumulator read 3.5e-6 mean off the plain version, 8
// k-tiles 1.0e-6), so every window of 8 k-tiles (K = 256) both accumulators
// are added to a third on the CUDA cores, rounded to nearest, and
// restarted: one drain of the wgmma pipeline per window. Every operand is a
// plane of exact TF32 values (low 13 bits zero), so how the tensor core
// treats the bits it ignores does not matter. Rows past M read as zeros
// (TMA) and are not stored.
//
// kSplitA (K3-f32): A is an f32 matrix that no pass has split. The producer
// loads it once, as f32, into the stage's A_hi slot (48 KB per stage), and
// each consumer warpgroup splits its own 64 rows in shared memory: hi over
// the f32 values, lo into the A_lo slot at the same offsets. The split is
// elementwise and both slots are 1024-byte aligned, so TMA's swizzle holds
// for both planes and the descriptors of the plain path read them
// unchanged. The warpgroup then makes its stores visible to the async proxy
// (fence.proxy.async) and meets on a named barrier of its 128 threads
// before it issues wgmma on the stage. Its empty-barrier arrival for the
// stage follows the wgmma_wait that retires the group, as on the plain
// path, so TMA refills a slot only after every consumer warp has split it
// and finished reading it.
//
// Everything is in an anonymous namespace: each source that includes it
// gets its own copy.

#pragma once

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
constexpr int kSplitThreads = 256;         // the split and reduce passes
constexpr int kSplitVecs = 4;              // weight float4s per thread of a split pass

// shared memory, from a 1024-byte aligned base: per stage the A_hi, A_lo
// (rows) and B_hi, B_lo (output columns) tiles, [128][32] f32 each; then the
// barriers
constexpr uint32_t kTileBytes = 128 * kBK * 4;      // 16 KB
constexpr uint32_t kStageBytes = 4 * kTileBytes;    // 64 KB
constexpr uint32_t kBarFull = kStages * kStageBytes;
constexpr uint32_t kBarEmpty = kBarFull + 8 * kStages;
constexpr uint32_t kSmemBytes = kBarEmpty + 8 * kStages + 1024;
// a consumer warpgroup's share of an A tile: 64 rows of 128 bytes, as float4s
// per thread
constexpr int kSplitAVecs = kTileBytes / kWG / 16 / 128;

static_assert(kBM == 128 && kBN == 128, "A and B tiles share one box shape");
static_assert(kBK * 4 == 128, "a k-tile row is one 128-byte swizzle row");
static_assert(kTileBytes % 1024 == 0, "1024-byte swizzle atoms");
static_assert(kSplitAVecs * 16 * 128 * kWG == kTileBytes, "the split covers the A tile");
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs == kThreads * 168,
              "setmaxnreg must hand over exactly the registers it frees");
static_assert(kSmemBytes <= 232448, "over the per-block shared memory");
// the hidden widths a caller may instantiate its passes for: whole tiles
template <int kH>
constexpr bool kWholeTiles = kH % kBN == 0 && kH % kBK == 0;

enum Epilogue { kGelu, kPartial };

// The operand planes of `v`: hi = tf32(v), lo = v - hi (exact)
__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  hi = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
  lo = make_float4(v.x - hi.x, v.y - hi.y, v.z - hi.z, v.w - hi.w);
}

__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_f4(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// The producer thread: k-tiles k_begin .. k_begin + n_k of the A planes
// (rows row0 ..) and the B planes (output columns col0 ..), one stage each.
// kSplitA: A once, as f32, into the A_hi slot (a_lo is not read).
template <bool kSplitA>
__device__ __forceinline__ void produce(const CUtensorMap* a_hi, const CUtensorMap* a_lo,
                                        const CUtensorMap* b_hi, const CUtensorMap* b_lo,
                                        uint32_t base, int row0, int col0, int k_begin,
                                        int n_k) {
  constexpr uint32_t kBytes = kSplitA ? kStageBytes - kTileBytes : kStageBytes;
  Ring ring;
  for (int t = 0; t < n_k; ++t) {
    mbar_wait(base + kBarEmpty + 8 * ring.slot, ring.phase ^ 1);
    const uint32_t full = base + kBarFull + 8 * ring.slot;
    const uint32_t dst = base + ring.slot * kStageBytes;
    const int k0 = (k_begin + t) * kBK;
    mbar_arrive_expect_tx(full, kBytes);
    tma_load_2d(dst, a_hi, full, k0, row0);
    if constexpr (!kSplitA) tma_load_2d(dst + kTileBytes, a_lo, full, k0, row0);
    tma_load_2d(dst + 2 * kTileBytes, b_hi, full, k0, col0);
    tma_load_2d(dst + 3 * kTileBytes, b_lo, full, k0, col0);
    ring.next<kStages>();
  }
}

// kSplitA: consumer wg's 64 rows of the stage's f32 A tile at `a_hi` into
// its TF32 planes, hi in place and lo kTileBytes on, at the same (swizzled)
// offsets; then the stores are made visible to wgmma and the warpgroup's
// 128 threads meet (named barrier 1 + wg).
__device__ __forceinline__ void split_a(uint32_t a_hi, int wg) {
  const int tid = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < kSplitAVecs; ++i) {
    const uint32_t at = a_hi + 16 * (tid + 128 * i);
    float4 hi, lo;
    split4(ld_shared_f4(at), hi, lo);
    st_shared_f4(at, hi);
    st_shared_f4(at + kTileBytes, lo);
  }
  mrd::fence_proxy_async();
  mrd::named_bar_sync<128>(1 + wg);
}

// Consumer wg's share of one k-tile: for each of its 4 k8 steps,
// big += A_hi . B_hi and small += A_hi . B_lo + A_lo . B_hi, on its 64 rows
// of the stage's A tiles (kSplitA: split first, by split_a). After the group
// is issued the previous one is retired and its stage released (one arrival
// per warp). kFirst: the first k-tile of a window, whose first step writes
// the accumulators without reading them (no group is in flight before it).
template <bool kFirst, bool kSplitA>
__device__ __forceinline__ void consume(float (&big)[64], float (&small)[64], Ring& ring,
                                        uint32_t& prev, uint32_t base, int wg, bool signal) {
  mbar_wait(base + kBarFull + 8 * ring.slot, ring.phase);
  const uint32_t st = opaque(base) + ring.slot * kStageBytes;
  const uint32_t a_hi = st + wg * (kTileBytes / 2), a_lo = a_hi + kTileBytes;
  const uint32_t b_hi = st + 2 * kTileBytes, b_lo = st + 3 * kTileBytes;
  if constexpr (kSplitA) split_a(a_hi, wg);
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
// planes of [M, K] (rows blockIdx.y * 128 ..; kSplitA: A itself, in f32), B
// the planes of [N, K] (output columns blockIdx.x * 128 ..). kGelu: out =
// GELU(C + bias) as the planes out_hi, out_lo [M, N]. kPartial:
// out_hi[blockIdx.z] [M, N] = C.
template <Epilogue kEpi, bool kSplitA = false>
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
      produce<kSplitA>(&a_hi_map, &a_lo_map, &b_hi_map, &b_lo_map, base, row0, col0,
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
    consume<true, kSplitA>(big, small, ring, prev, base, wg, signal);
    for (int t = t0 + 1; t < t1; ++t)
      consume<false, kSplitA>(big, small, ring, prev, base, wg, signal);
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

// y = LN(sum_s partial[s] + b + x), the slices summed in order 0 .. S-1, x
// from load_row_f32 (LN0 of z for K1, z itself for K2 and K3). One warp per
// row, 8 rows per block.
template <int kH, bool kInputLN>
__global__ void __launch_bounds__(kSplitThreads)
split_reduce_f32(const float* __restrict__ partial, int slices, const float* __restrict__ z,
                 const float* __restrict__ b2, const float* __restrict__ gamma,
                 const float* __restrict__ beta, const float* __restrict__ g0,
                 const float* __restrict__ o0, float* __restrict__ y, int M, float eps) {
  static_assert(kWholeTiles<kH>, "whole tiles");
  const int lane = threadIdx.x % 32;
  const long long gr = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (gr >= M) return;
  float4 v[kF32RowVecs<kH>];
  load_row_f32<kH, kInputLN>(z, gr, M, g0, o0, eps, lane, v);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kF32RowVecs<kH>; ++j) {
    const int c = 4 * (lane + 32 * j);
    float4 acc = *reinterpret_cast<const float4*>(partial + gr * kH + c);
    for (int sl = 1; sl < slices; ++sl) {
      const float4 a = *reinterpret_cast<const float4*>(
          partial + (sl * static_cast<long long>(M) + gr) * kH + c);
      acc = make_float4(acc.x + a.x, acc.y + a.y, acc.z + a.z, acc.w + a.w);
    }
    const float4 b = *reinterpret_cast<const float4*>(b2 + c);
    v[j] = make_float4(acc.x + b.x + v[j].x, acc.y + b.y + v[j].y, acc.z + b.z + v[j].z,
                       acc.w + b.w + v[j].w);
    s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
  }
  const float mu = mrd::warp_sum(s) * (1.0f / kH);
  float q = 0.0f;
#pragma unroll
  for (int j = 0; j < kF32RowVecs<kH>; ++j) {
    const float4 d = make_float4(v[j].x - mu, v[j].y - mu, v[j].z - mu, v[j].w - mu);
    q += (d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w);
  }
  const float rstd = rsqrtf(mrd::warp_sum(q) * (1.0f / kH) + eps);
#pragma unroll
  for (int j = 0; j < kF32RowVecs<kH>; ++j) {
    const int c = 4 * (lane + 32 * j);
    const float4 g = *reinterpret_cast<const float4*>(gamma + c);
    const float4 o = *reinterpret_cast<const float4*>(beta + c);
    *reinterpret_cast<float4*>(y + gr * kH + c) =
        make_float4((v[j].x - mu) * rstd * g.x + o.x, (v[j].y - mu) * rstd * g.y + o.y,
                    (v[j].z - mu) * rstd * g.z + o.z, (v[j].w - mu) * rstd * g.w + o.w);
  }
}

// gemm_tf32x3<kEpi, kSplitA> on `stream`: A [M, K] as its planes a_hi, a_lo
// (kSplitA: a_hi is A in f32 and a_lo is not read), B [N, K] as b_hi, b_lo;
// the k loop in `slices` slices (a divisor of K / 32).
template <Epilogue kEpi, bool kSplitA = false>
cudaError_t launch_gemm(const float* a_hi, const float* a_lo, const float* b_hi,
                        const float* b_lo, const float* bias, float* out_hi, float* out_lo,
                        int M, int N, int K, int slices, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!make_map_f32(&maps[0], a_hi, M, K, kBM) ||
      !make_map_f32(&maps[1], kSplitA ? a_hi : a_lo, M, K, kBM) ||
      !make_map_f32(&maps[2], b_hi, N, K, kBN) || !make_map_f32(&maps[3], b_lo, N, K, kBN))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_tf32x3<kEpi, kSplitA>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM, slices);
  gemm_tf32x3<kEpi, kSplitA><<<grid, kThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bias, out_hi, out_lo, M, N, K / kBK / slices);
  return cudaGetLastError();
}

}  // namespace
