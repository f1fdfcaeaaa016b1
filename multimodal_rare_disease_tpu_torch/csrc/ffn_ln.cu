// K1 and K2: the post-LN BERT FFN sublayer, written by hand for Hopper
// (sm_90a). One kernel template, `kInputLN`:
//
//   K1 (kInputLN = true):  x = bf16(LN0(z))  z: [M, 768] bf16, the unnormalized
//                                               attention residual
//   K2 (kInputLN = false): x = the input rows [M, 768] bf16 as they are (the
//                          already-normalized output of K3, attn_out_ln.cu)
//
//   h = bf16(GELU(x . W1 + b1))              W1: [768, F] bf16, f32 accumulator,
//                                               exact-erf GELU in f32
//   y = bf16(LN2(f32(x) + h . W2 + b2))      W2: [F, 768] bf16
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
// What bounds it on the H100: the FLOP count is far above the card's ridge
// (at the packed batch of 256 documents, M of 16k-24k rows, one call is
// 4*M*768*F = 155-232 GFLOP against 60-85 MB of device-memory traffic), and
// the [M, F] intermediate never goes to device memory: each block keeps a
// [32, 64] chunk of it in shared memory and folds it into a [32, 768] f32
// accumulator held in registers. With 32 rows per block every block streams
// the whole of W1 and W2 (9.4 MB, resident in the 50 MB L2), so what bounds
// this design is L2-to-SM bandwidth; a larger row tile (wgmma, clusters
// sharing weight tiles) is the next step.
//
// Design (simple and right first):
//   - one block of 8 warps per tile of 32 rows; ragged rows are masked, so
//     any M >= 1 works (M = 1 for a single request's CLS-only last layer);
//   - K1: LN0 with warp reductions into a bf16 [32, 768] tile in shared
//     memory; K2: the input rows copied into that tile as they are;
//   - the weights stream through a 4-deep ring of 16-18 KB shared-memory
//     tiles filled with cp.async, three tiles ahead of the math: per F chunk
//     of 64, six W1 tiles [64 f x 128 k] then six W2 tiles [128 h x 64 f];
//   - WMMA bf16 16x16x16 with f32 accumulation: x . W1[:, chunk] + b1 ->
//     GELU -> bf16 chunk in shared memory, then chunk . W2[chunk, :] into
//     the accumulator, 12 fragments per warp (warp w owns output columns
//     128 j + 16 w .. +16 for j = 0..5, all 32 rows);
//   - the residual + b2 + LN2 epilogue, then a bf16 store.
// The weights are read in the layout of torch.nn.Linear ([out, in],
// row-major), i.e. W1 and W2 column-major, which is WMMA's col_major B.

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
constexpr int kFC = 64;                 // F chunk per loop step
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowTiles = kTM / 16;     // 2
constexpr int kPerLane = kH / 32;       // 24 columns per lane in LN passes

// weight tiles streamed per F chunk: W1 in k-slices, W2 in h-slices
constexpr int kK1 = 128;                // k (= H) columns of a W1 tile
constexpr int kN2 = 128;                // h rows of a W2 tile
constexpr int kW1Tiles = kH / kK1;      // 6
constexpr int kW2Tiles = kH / kN2;      // 6
constexpr int kTilesPerChunk = kW1Tiles + kW2Tiles;
constexpr int kStages = 4;              // ring depth (3 tiles in flight)

// shared-memory row strides, padded against bank conflicts (multiples of
// 8 bf16 / 4 f32 elements as WMMA's ldm requires, rows 16-byte aligned)
constexpr int kXS = kH + 8;             // bf16 x tile
constexpr int kHS = kFC + 8;            // bf16 GELU chunk
constexpr int kPS = kFC + 4;            // f32 stage-1 staging
constexpr int kAS = kH + 4;             // f32 accumulator staging
constexpr int kW1S = kK1 + 8;           // bf16 W1 tile [64 f][128 k]
constexpr int kW2S = kFC + 8;           // bf16 W2 tile [128 h][64 f]

constexpr size_t kXBytes = align128(sizeof(bf16) * kTM * kXS);
constexpr size_t kHBytes = align128(sizeof(bf16) * kTM * kHS);
constexpr size_t kPBytes = align128(sizeof(float) * kTM * kPS);
constexpr size_t kSlotBytes =
    align128(cmax(sizeof(bf16) * kFC * kW1S, sizeof(bf16) * kN2 * kW2S));
constexpr size_t kABytes = sizeof(float) * kTM * kAS;
// the epilogue staging aliases the stage-1 staging and the ring, which are
// no longer live by then
constexpr size_t kUnionBytes = cmax(kPBytes + kStages * kSlotBytes, kABytes);
constexpr size_t kSmemBytes = kXBytes + kHBytes + kUnionBytes;

static_assert(kWarps == kRowTiles * (kFC / 16), "one stage-1 tile per warp");
static_assert(kN2 == 16 * kWarps, "one W2 column tile per warp per tile");
static_assert(kTM % kWarps == 0, "rows must split evenly over warps");
static_assert(kFC * kK1 / 8 == 4 * kThreads, "W1 tile: 4 copies per thread");
static_assert(kN2 * kFC / 8 == 4 * kThreads, "W2 tile: 4 copies per thread");
static_assert(kSmemBytes <= 227 * 1024, "over the per-block shared memory");

// Issue this thread's share of weight tile g (chunk g / 12, tile g % 12)
// into `slot`; tiles past the end issue nothing. Every thread commits one
// group per call, so group counts stay uniform.
__device__ __forceinline__ void load_tile(int g, int n_tiles, bf16* slot,
                                          const bf16* __restrict__ w1t,
                                          const bf16* __restrict__ w2t, int F) {
  if (g < n_tiles) {
    const int f0 = (g / kTilesPerChunk) * kFC;
    const int t = g % kTilesPerChunk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = threadIdx.x + i * kThreads;
      if (t < kW1Tiles) {  // W1^T[f0 + row, k0 + col]
        const int row = q / (kK1 / 8), col = (q % (kK1 / 8)) * 8;
        cp_async16(slot + row * kW1S + col,
                   w1t + static_cast<size_t>(f0 + row) * kH + t * kK1 + col);
      } else {             // W2^T[h0 + row, f0 + col]
        const int row = q / (kFC / 8), col = (q % (kFC / 8)) * 8;
        const int h0 = (t - kW1Tiles) * kN2;
        cp_async16(slot + row * kW2S + col,
                   w2t + static_cast<size_t>(h0 + row) * F + f0 + col);
      }
    }
  }
  cp_async_commit();
}

// V: the type of the bias and LayerNorm vectors (float or bf16; bf16 only
// for K2);
// kInputLN: K1 (LN0 of z in the prologue) or K2 (z is x; g0, o0 unused)
template <typename V, bool kInputLN>
__global__ void __launch_bounds__(kThreads, 1)
ffn_ln_kernel(const bf16* __restrict__ z,         // [M, H]
                  const bf16* __restrict__ w1t,   // [F, H]  (W1 transposed)
                  const V* __restrict__ b1,       // [F]
                  const bf16* __restrict__ w2t,   // [H, F]  (W2 transposed)
                  const V* __restrict__ b2,       // [H]
                  const V* __restrict__ gamma,
                  const V* __restrict__ beta,
                  const V* __restrict__ g0,       // LN0 scale [H] (K1)
                  const V* __restrict__ o0,       // LN0 bias [H] (K1)
                  bf16* __restrict__ y,           // [M, H]
                  int M, int F, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + kXBytes);
  float* ps = reinterpret_cast<float*>(smem + kXBytes + kHBytes);
  unsigned char* ring = smem + kXBytes + kHBytes + kPBytes;
  float* accs = ps;  // epilogue only: aliases ps and the ring
  auto slot = [&](int g) {
    return reinterpret_cast<bf16*>(ring + (g % kStages) * kSlotBytes);
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTM;
  const float inv_h = 1.0f / kH;
  const int n_tiles = (F / kFC) * kTilesPerChunk;

  // start the weight stream, then normalize while it is in flight
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_tile(s, n_tiles, slot(s), w1t, w2t, F);

  // ---- prologue: each warp fills kTM / kWarps rows of the bf16 x tile:
  // LN0(z) for K1, the rows themselves for K2 (zeros past M either way)
  for (int r = warp; r < kTM; r += kWarps) {
    const long long gr = row0 + r;
    if constexpr (!kInputLN) {
      const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        xs[r * kXS + lane + 32 * j] = gr < M ? z[gr * kH + lane + 32 * j] : zero;
    } else {
      float v[kPerLane];
      if (gr < M) {
        const bf16* src = z + gr * kH;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) v[j] = __bfloat162float(src[lane + 32 * j]);
      } else {
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) v[j] = 0.0f;
      }
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) s += v[j];
      const float mu = warp_sum(s) * inv_h;
      float q = 0.0f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) q += (v[j] - mu) * (v[j] - mu);
      const float rstd = rsqrtf(warp_sum(q) * inv_h + eps);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int c = lane + 32 * j;
        xs[r * kXS + c] =
            __float2bfloat16((v[j] - mu) * rstd * ld_f32(g0 + c) + ld_f32(o0 + c));
      }
    }
  }
  // (the first tile's barrier below also publishes the x tile)

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowTiles][kW2Tiles];
#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt)
#pragma unroll
    for (int j = 0; j < kW2Tiles; ++j) wmma::fill_fragment(acc[rt][j], 0.0f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> p;

  // this warp's stage-1 tile within a chunk: rows r1*16.., chunk cols c1*16..
  const int r1 = warp % kRowTiles;
  const int c1 = warp / kRowTiles;

  for (int f0 = 0, g = 0; f0 < F; f0 += kFC) {
#pragma unroll
    for (int t = 0; t < kTilesPerChunk; ++t, ++g) {
      // tile g has landed for every thread, and every warp is done with
      // tile g - 1, whose slot the next load reuses
      cp_async_wait<kStages - 2>();
      __syncthreads();
      load_tile(g + kStages - 1, n_tiles, slot(g + kStages - 1), w1t, w2t, F);
      const bf16* w = slot(g);
      if (t < kW1Tiles) {
        // ---- stage 1: P[32, 64] += X[:, k-slice] . W1[k-slice, chunk]
        if (t == 0) wmma::fill_fragment(p, 0.0f);
#pragma unroll
        for (int kk = 0; kk < kK1; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(a, xs + r1 * 16 * kXS + t * kK1 + kk, kXS);
          wmma::load_matrix_sync(b, w + c1 * 16 * kW1S + kk, kW1S);
          wmma::mma_sync(p, a, b, p);
        }
        if (t == kW1Tiles - 1) {
          wmma::store_matrix_sync(ps + r1 * 16 * kPS + c1 * 16, p, kPS,
                                  wmma::mem_row_major);
          __syncthreads();
          // ---- bias + exact-erf GELU in f32, rounded to the bf16 chunk
          for (int i = threadIdx.x; i < kTM * kFC; i += kThreads) {
            const int r = i / kFC;
            const int c = i % kFC;
            const float v = ps[r * kPS + c] + ld_f32(b1 + f0 + c);
            hs[r * kHS + c] =
                __float2bfloat16(0.5f * v * (1.0f + erff(v * 0.70710678118654752f)));
          }
          // the next tile's barrier publishes hs before stage 2 reads it
        }
      } else {
        // ---- stage 2: ACC[:, h-slice] += Hc[32, 64] . W2[chunk, h-slice]
        const int j = t - kW1Tiles;
#pragma unroll
        for (int kk = 0; kk < kFC; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, w + warp * 16 * kW2S + kk, kW2S);
#pragma unroll
          for (int rt = 0; rt < kRowTiles; ++rt) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
            wmma::load_matrix_sync(a, hs + rt * 16 * kHS + kk, kHS);
            wmma::mma_sync(acc[rt][j], a, b, acc[rt][j]);
          }
        }
      }
    }
  }

  // ---- epilogue: residual + b2 + LN2, bf16 store of the valid rows
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before it is reused
#pragma unroll
  for (int rt = 0; rt < kRowTiles; ++rt)
#pragma unroll
    for (int j = 0; j < kW2Tiles; ++j)
      wmma::store_matrix_sync(accs + rt * 16 * kAS + j * kN2 + warp * 16, acc[rt][j],
                              kAS, wmma::mem_row_major);
  __syncthreads();

  for (int r = warp; r < kTM; r += kWarps) {
    const long long gr = row0 + r;
    if (gr >= M) break;  // rows are visited in increasing order
    float v[kPerLane];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + 32 * j;
      v[j] = accs[r * kAS + c] + ld_f32(b2 + c) + __bfloat162float(xs[r * kXS + c]);
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

template <typename V, bool kInputLN>
cudaError_t launch(const void* z, const void* w1t, const void* b1, const void* w2t,
                   const void* b2, const void* gamma, const void* beta, const void* g0,
                   const void* o0, void* y, int M, int F, float eps,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ffn_ln_kernel<V, kInputLN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kTM - 1) / kTM);
  ffn_ln_kernel<V, kInputLN><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const bf16*>(z), static_cast<const bf16*>(w1t),
      static_cast<const V*>(b1), static_cast<const bf16*>(w2t), static_cast<const V*>(b2),
      static_cast<const V*>(gamma), static_cast<const V*>(beta), static_cast<const V*>(g0),
      static_cast<const V*>(o0), static_cast<bf16*>(y), M, F, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory per block of the FFN kernel.
int mrd_ffn_smem_bytes() { return static_cast<int>(kSmemBytes); }

const char* mrd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1: y = LN2(x + GELU(x W1 + b1) W2 + b2), x = LN0(z), on `stream`.
// Pointers are device pointers; w1t is [F, H] and w2t is [H, F], row-major,
// 16-byte aligned. The six vectors are f32, or bf16 when vec_bf16 is non-zero.
// Returns the cudaError_t of the launch (0 on success). Allocates nothing.
int mrd_ffn_pre_ln_bf16(const void* z, const void* w1t, const void* b1,
                        const void* w2t, const void* b2, const void* gamma,
                        const void* beta, const void* g0, const void* o0,
                        void* y, int M, int F, float eps, int vec_bf16,
                        void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  if (F <= 0 || F % kFC != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec_bf16
          ? launch<bf16, true>(z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y, M, F, eps, s)
          : launch<float, true>(z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y, M, F, eps, s));
}

// K2: y = LN(x + GELU(x W1 + b1) W2 + b2) with x the input rows as they are,
// on `stream`. Arguments as mrd_ffn_pre_ln_bf16 without the LN0 vectors; the
// four vectors are bf16.
int mrd_ffn_ln_bf16(const void* x, const void* w1t, const void* b1, const void* w2t,
                    const void* b2, const void* gamma, const void* beta, void* y,
                    int M, int F, float eps, void* stream) {
  if (M <= 0) return static_cast<int>(cudaSuccess);
  if (F <= 0 || F % kFC != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<bf16, false>(x, w1t, b1, w2t, b2, gamma, beta, nullptr,
                                              nullptr, y, M, F, eps,
                                              static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
