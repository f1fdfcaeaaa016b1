// K3: the post-LN BERT attention-output sublayer, written by hand for Hopper
// (sm_90a):
//
//   y = bf16(LN(f32(x) + ctx . Wo^T + bo))   ctx, x: [M, 768] bf16; Wo: [768, 768]
//                                             bf16 in torch.nn.Linear's [out, in]
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
// does 2*M*768*768 = 19.3 GFLOP, so device memory bounds it (0.023 ms at
// 3.35 TB/s against 0.020 ms at the bf16 tensor-core peak); the two are
// close, so the product has to run near the tensor-core rate too. The design
// reads ctx and x once and writes y once (the classic path writes the
// projection and the residual sum and reads them back for the LayerNorm).
// With 32 rows per block every block streams all of Wo (1.2 MB, resident in
// L2), so L2-to-SM traffic and the WMMA rate bound this simple design; a
// 64-row wgmma tile is the next step.
//
// Design (K1's second half with K = 768, csrc/ffn_ln.cu):
//   - one block of 8 warps per tile of 32 full rows (LayerNorm needs whole
//     768-wide rows); ragged rows are masked, so any M >= 1 works;
//   - the bf16 [32, 768] ctx tile is staged in shared memory;
//   - Wo streams through a 4-deep ring of 18 KB shared-memory tiles filled
//     with cp.async, three tiles ahead of the math: per k chunk of 64, six
//     tiles [128 out x 64 k], read as nn.Linear's [out, in] rows (WMMA's
//     col_major B, no transpose);
//   - WMMA bf16 16x16x16 into a [32, 768] f32 accumulator in registers, 12
//     fragments per warp (warp w owns output columns 128 j + 16 w .. +16 for
//     j = 0..5, all 32 rows);
//   - the bo + residual + LN epilogue, then a bf16 store.

#include <mma.h>

#include "common.cuh"

namespace {

using mrd::bf16;
using mrd::align128;
using mrd::cmax;
using mrd::cp_async16;
using mrd::cp_async_commit;
using mrd::cp_async_wait;
using mrd::ld_f32;
using mrd::warp_sum;
namespace wmma = nvcuda::wmma;

constexpr int kH = 768;                 // hidden width (BERT-base)
constexpr int kTM = 32;                 // rows per block
constexpr int kKC = 64;                 // k chunk of a Wo tile
constexpr int kN = 128;                 // output columns of a Wo tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowTiles = kTM / 16;     // 2
constexpr int kColTiles = kH / kN;      // 6 tiles per k chunk
constexpr int kTiles = (kH / kKC) * kColTiles;  // 72
constexpr int kPerLane = kH / 32;       // 24 columns per lane in the epilogue
constexpr int kStages = 4;              // ring depth (3 tiles in flight)

// shared-memory row strides, padded against bank conflicts (multiples of
// 8 bf16 / 4 f32 elements as WMMA's ldm requires, rows 16-byte aligned)
constexpr int kXS = kH + 8;             // bf16 ctx tile
constexpr int kWS = kKC + 8;            // bf16 Wo tile [128 out][64 k]
constexpr int kAS = kH + 4;             // f32 accumulator staging

constexpr size_t kXBytes = align128(sizeof(bf16) * kTM * kXS);
constexpr size_t kSlotBytes = align128(sizeof(bf16) * kN * kWS);
constexpr size_t kABytes = sizeof(float) * kTM * kAS;
// the epilogue staging aliases the ring, which is no longer live by then
constexpr size_t kSmemBytes = kXBytes + cmax(kStages * kSlotBytes, kABytes);

static_assert(kN == 16 * kWarps, "one output column tile per warp per tile");
static_assert(kN * kKC / 8 == 4 * kThreads, "Wo tile: 4 copies per thread");
static_assert(kTM * kH / 8 % kThreads == 0, "ctx tile: whole copies per thread");
static_assert(kSmemBytes <= 227 * 1024, "over the per-block shared memory");

// Issue this thread's share of Wo tile g (k chunk g / 6, columns (g % 6) * 128)
// into `slot`; tiles past the end issue nothing. Every thread commits one
// group per call, so group counts stay uniform.
__device__ __forceinline__ void load_tile(int g, bf16* slot, const bf16* __restrict__ wo) {
  if (g < kTiles) {
    const int k0 = (g / kColTiles) * kKC;
    const int n0 = (g % kColTiles) * kN;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = threadIdx.x + i * kThreads;
      const int row = q / (kKC / 8), col = (q % (kKC / 8)) * 8;
      cp_async16(slot + row * kWS + col,
                 wo + static_cast<size_t>(n0 + row) * kH + k0 + col);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
attn_out_ln_kernel(const bf16* __restrict__ ctx,   // [M, H]
                   const bf16* __restrict__ x,     // [M, H] residual
                   const bf16* __restrict__ wo,    // [H, H] nn.Linear [out, in]
                   const bf16* __restrict__ bo,    // [H]
                   const bf16* __restrict__ gamma,
                   const bf16* __restrict__ beta,
                   bf16* __restrict__ y,           // [M, H]
                   int M, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* cs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + kXBytes;
  float* accs = reinterpret_cast<float*>(ring);  // epilogue only
  auto slot = [&](int g) {
    return reinterpret_cast<bf16*>(ring + (g % kStages) * kSlotBytes);
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTM;
  const float inv_h = 1.0f / kH;

  // start the weight stream, then stage the ctx tile while it is in flight
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_tile(s, slot(s), wo);

  constexpr int kVecPerRow = kH / 8;  // 16-byte vectors of 8 bf16
  for (int q = threadIdx.x; q < kTM * kVecPerRow; q += kThreads) {
    const int r = q / kVecPerRow, c = (q % kVecPerRow) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < M) v = *reinterpret_cast<const uint4*>(ctx + (row0 + r) * kH + c);
    *reinterpret_cast<uint4*>(cs + r * kXS + c) = v;
  }
  // (the first tile's barrier below also publishes the ctx tile)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowTiles][kColTiles];
#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt)
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) wmma::fill_fragment(acc[rt][j], 0.0f);

  for (int k0 = 0, g = 0; k0 < kH; k0 += kKC) {
#pragma unroll
    for (int j = 0; j < kColTiles; ++j, ++g) {
      // tile g has landed for every thread, and every warp is done with
      // tile g - 1, whose slot the next load reuses
      cp_async_wait<kStages - 2>();
      __syncthreads();
      load_tile(g + kStages - 1, slot(g + kStages - 1), wo);
      const bf16* w = slot(g);
      // ACC[:, 128 j + 16 w ..] += CTX[:, k-chunk] . Wo^T[k-chunk, ..]
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w + warp * 16 * kWS + kk, kWS);
#pragma unroll
        for (int rt = 0; rt < kRowTiles; ++rt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, cs + rt * 16 * kXS + k0 + kk, kXS);
          wmma::mma_sync(acc[rt][j], a, b, acc[rt][j]);
        }
      }
    }
  }

  // ---- epilogue: bo + residual + LN, bf16 store of the valid rows
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before it is reused
#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt)
#pragma unroll
    for (int j = 0; j < kColTiles; ++j)
      wmma::store_matrix_sync(accs + rt * 16 * kAS + j * kN + warp * 16, acc[rt][j],
                              kAS, wmma::mem_row_major);
  __syncthreads();

  for (int r = warp; r < kTM; r += kWarps) {
    const long long gr = row0 + r;
    if (gr >= M) break;  // rows are visited in increasing order
    const bf16* xr = x + gr * kH;
    float v[kPerLane];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + 32 * j;
      v[j] = accs[r * kAS + c] + ld_f32(bo + c) + __bfloat162float(xr[c]);
      s += v[j];
    }
    const float mu = warp_sum(s) * inv_h;
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) q += (v[j] - mu) * (v[j] - mu);
    const float rstd = rsqrtf(warp_sum(q) * inv_h + eps);
    bf16* dst = y + gr * kH;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + 32 * j;
      dst[c] = __float2bfloat16((v[j] - mu) * rstd * ld_f32(gamma + c) + ld_f32(beta + c));
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory per block of the attention-output kernel.
int mrd_attn_out_smem_bytes() { return static_cast<int>(kSmemBytes); }

// y = LN(x + ctx Wo^T + bo) on `stream`. Pointers are device pointers; ctx,
// x and y are [M, 768] row-major, wo is [768 out, 768 in] row-major, bo,
// gamma and beta are [768]; all bf16, ctx and wo 16-byte aligned. Returns
// the cudaError_t of the launch (0 on success). Allocates nothing.
int mrd_attn_out_ln_bf16(const void* ctx, const void* x, const void* wo, const void* bo,
                         const void* gamma, const void* beta, void* y, int M, float eps,
                         void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(attn_out_ln_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kTM - 1) / kTM);
  attn_out_ln_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(ctx), static_cast<const bf16*>(x),
      static_cast<const bf16*>(wo), static_cast<const bf16*>(bo),
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
      static_cast<bf16*>(y), M, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
