// Pieces shared by the port's bf16 row kernels (ffn_ln.cuh, attn_out_ln.cuh),
// templates over the hidden width kH (768 for BERT-base, 1,024 for
// BERT-large, 512 / 256 / 128 for the compact BERTs, 384 for MiniLM, 640
// and 896, and 1,152 to 1,536): the residual row as kH / 256 16-byte
// groups per lane, or,
// where kH is an odd multiple of 128, kH / 128 8-byte groups per lane
// (with LN0 for K1), the second pass of the split paths
// (y = LN(sum of f32 partials + b + x), the partials summed in slice order,
// so no atomics and the same bits on every launch) and the TMA tensor maps
// of row-major bf16 and f32 matrices (the f32 ones for the f32 kernels).
// Both LayerNorms are two-pass in f32. Everything is in an anonymous
// namespace: each source that includes it gets its own copy.

#pragma once

#include <cuda.h>

#include "common.cuh"

namespace {

// 16-byte groups per lane of a kH-wide bf16 row: 3 at 768, 4 at 1,024, 6
// at 1,536 (a multiple of 256; the odd multiples of 128 take the narrow
// forms below)
template <int kH>
constexpr int kRowGroupsPerLane = kH / 8 / 32;

// x row `gr` as kRowGroupsPerLane<kH> 16-byte groups per lane (columns
// 8 (lane + 32 j) .. + 8): LN0 of z in f32, rounded to bf16 (K1), or z
// itself (K2, K3); zeros past M. One warp per row; the main kernels and the
// split reduction both take x from here, so they see the same bits.
template <int kH, typename V, bool kInputLN>
__device__ __forceinline__ void load_x_row(const mrd::bf16* __restrict__ z, long long gr,
                                           int M, const V* __restrict__ g0,
                                           const V* __restrict__ o0, float eps, int lane,
                                           uint4 (&out)[kRowGroupsPerLane<kH>]) {
  static_assert(kH % 256 == 0, "whole 16-byte groups per lane");
  if (gr >= M) {
#pragma unroll
    for (int j = 0; j < kRowGroupsPerLane<kH>; ++j) out[j] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(z + gr * kH);
#pragma unroll
  for (int j = 0; j < kRowGroupsPerLane<kH>; ++j) out[j] = src[lane + 32 * j];
  if constexpr (kInputLN) {
    float v[kRowGroupsPerLane<kH>][8];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kRowGroupsPerLane<kH>; ++j) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&out[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        v[j][2 * e] = f.x;
        v[j][2 * e + 1] = f.y;
        s += f.x + f.y;
      }
    }
    const float mu = mrd::warp_sum(s) * (1.0f / kH);
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < kRowGroupsPerLane<kH>; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) q += (v[j][e] - mu) * (v[j][e] - mu);
    const float rstd = rsqrtf(mrd::warp_sum(q) * (1.0f / kH) + eps);
#pragma unroll
    for (int j = 0; j < kRowGroupsPerLane<kH>; ++j) {
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out[j]);
      const int c = 8 * (lane + 32 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = c + 2 * e;
        p[e] = __floats2bfloat162_rn(
            (v[j][2 * e] - mu) * rstd * mrd::ld_f32(g0 + cc) + mrd::ld_f32(o0 + cc),
            (v[j][2 * e + 1] - mu) * rstd * mrd::ld_f32(g0 + cc + 1) +
                mrd::ld_f32(o0 + cc + 1));
      }
    }
  }
}

// The narrow form of load_x_row for a row of an odd number of 128-column
// blocks (128, 384, 640, 896, 1,152, 1,408), which has an odd number of
// half 16-byte groups per lane: kRowGroups8<kH> 8-byte groups per lane (columns
// 4 (lane + 32 j) .. + 4), LN0 of z in f32 rounded to bf16 (K1) or z
// itself; zeros past M. The same arithmetic as load_x_row, so the main
// kernel and the split reduction see the same bits.
template <int kH>
constexpr int kRowGroups8 = kH / 4 / 32;

template <int kH, typename V, bool kInputLN>
__device__ __forceinline__ void load_x_row_narrow(const mrd::bf16* __restrict__ z,
                                                  long long gr, int M,
                                                  const V* __restrict__ g0,
                                                  const V* __restrict__ o0, float eps, int lane,
                                                  uint2 (&out)[kRowGroups8<kH>]) {
  static_assert(kH % 256 == 128, "an odd number of half 16-byte groups per lane");
  if (gr >= M) {
#pragma unroll
    for (int j = 0; j < kRowGroups8<kH>; ++j) out[j] = make_uint2(0, 0);
    return;
  }
  const uint2* src = reinterpret_cast<const uint2*>(z + gr * kH);
#pragma unroll
  for (int j = 0; j < kRowGroups8<kH>; ++j) out[j] = src[lane + 32 * j];
  if constexpr (kInputLN) {
    float v[kRowGroups8<kH>][4];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kRowGroups8<kH>; ++j) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&out[j]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        v[j][2 * e] = f.x;
        v[j][2 * e + 1] = f.y;
        s += f.x + f.y;
      }
    }
    const float mu = mrd::warp_sum(s) * (1.0f / kH);
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < kRowGroups8<kH>; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) q += (v[j][e] - mu) * (v[j][e] - mu);
    const float rstd = rsqrtf(mrd::warp_sum(q) * (1.0f / kH) + eps);
#pragma unroll
    for (int j = 0; j < kRowGroups8<kH>; ++j) {
      __nv_bfloat162* w = reinterpret_cast<__nv_bfloat162*>(&out[j]);
      const int c = 4 * (lane + 32 * j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = c + 2 * e;
        w[e] = __floats2bfloat162_rn(
            (v[j][2 * e] - mu) * rstd * mrd::ld_f32(g0 + cc) + mrd::ld_f32(o0 + cc),
            (v[j][2 * e + 1] - mu) * rstd * mrd::ld_f32(g0 + cc + 1) +
                mrd::ld_f32(o0 + cc + 1));
      }
    }
  }
}

// split_reduce's row at H = 256 and at the odd multiples of 128 (128, 384,
// 640, 896, 1,152, 1,408): the lane's kH / 32 values, in runs of 8 columns
// 8 (lane + 32 j) .. + 8 (at the odd multiples runs of 4, 4 (lane + 32 j) .. + 4);
// the partials summed in slice order first and x read after them, then
// the arithmetic of the 768 form.
template <int kH, typename V, bool kInputLN>
__device__ __forceinline__ void split_reduce_compact(
    const float* __restrict__ partial, int slices, const mrd::bf16* __restrict__ z,
    const V* __restrict__ b, const V* __restrict__ gamma, const V* __restrict__ beta,
    const V* __restrict__ g0, const V* __restrict__ o0, mrd::bf16* __restrict__ y, int M,
    float eps, long long gr, int lane) {
  constexpr int kE = kH / 32;               // values per lane
  constexpr int kRun = kH % 256 == 0 ? 8 : 4;  // consecutive columns of a run
  constexpr int kRuns = kE / kRun;
  const auto col = [lane](int i) { return kRun * (lane + 32 * (i / kRun)) + i % kRun; };
  float v[kE];
#pragma unroll
  for (int r = 0; r < kRuns; ++r)
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      const int i = kRun * r + 4 * q;
      float4 acc = *reinterpret_cast<const float4*>(partial + gr * kH + col(i));
      for (int sl = 1; sl < slices; ++sl) {
        const float4 a = *reinterpret_cast<const float4*>(
            partial + (sl * static_cast<long long>(M) + gr) * kH + col(i));
        acc = make_float4(acc.x + a.x, acc.y + a.y, acc.z + a.z, acc.w + a.w);
      }
      v[i] = acc.x;
      v[i + 1] = acc.y;
      v[i + 2] = acc.z;
      v[i + 3] = acc.w;
    }
  // x as kE / 2 words of two bf16
  uint32_t xw[kE / 2];
  if constexpr (kH % 256 != 0) {
    uint2 g[kRowGroups8<kH>];
    load_x_row_narrow<kH, V, kInputLN>(z, gr, M, g0, o0, eps, lane, g);
#pragma unroll
    for (int j = 0; j < kRowGroups8<kH>; ++j) {
      xw[2 * j] = g[j].x;
      xw[2 * j + 1] = g[j].y;
    }
  } else {
    uint4 g[kRowGroupsPerLane<kH>];
    load_x_row<kH, V, kInputLN>(z, gr, M, g0, o0, eps, lane, g);
#pragma unroll
    for (int j = 0; j < kRowGroupsPerLane<kH>; ++j) {
      xw[4 * j] = g[j].x;
      xw[4 * j + 1] = g[j].y;
      xw[4 * j + 2] = g[j].z;
      xw[4 * j + 3] = g[j].w;
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int p = 0; p < kE / 2; ++p) {
    const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xw[p]));
    const int c = col(2 * p);
    v[2 * p] = v[2 * p] + mrd::ld_f32(b + c) + xf.x;
    v[2 * p + 1] = v[2 * p + 1] + mrd::ld_f32(b + c + 1) + xf.y;
    s += v[2 * p] + v[2 * p + 1];
  }
  const float mu = mrd::warp_sum(s) * (1.0f / kH);
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < kE; ++i) q += (v[i] - mu) * (v[i] - mu);
  const float rstd = rsqrtf(mrd::warp_sum(q) * (1.0f / kH) + eps);
  uint32_t out[kE / 2];
#pragma unroll
  for (int p = 0; p < kE / 2; ++p) {
    const int c = col(2 * p);
    const __nv_bfloat162 o = __floats2bfloat162_rn(
        (v[2 * p] - mu) * rstd * mrd::ld_f32(gamma + c) + mrd::ld_f32(beta + c),
        (v[2 * p + 1] - mu) * rstd * mrd::ld_f32(gamma + c + 1) + mrd::ld_f32(beta + c + 1));
    out[p] = *reinterpret_cast<const uint32_t*>(&o);
  }
  if constexpr (kH % 256 != 0) {
#pragma unroll
    for (int r = 0; r < kRuns; ++r)
      *reinterpret_cast<uint2*>(y + gr * kH + col(kRun * r)) =
          make_uint2(out[2 * r], out[2 * r + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < kRuns; ++r)
      *reinterpret_cast<uint4*>(y + gr * kH + col(kRun * r)) =
          make_uint4(out[4 * r], out[4 * r + 1], out[4 * r + 2], out[4 * r + 3]);
  }
}

// The split paths' second pass: y = LN(sum_s partial[s] + b + x), the
// slices summed in order 0 .. S-1, x from load_x_row (LN0 of z for K1).
// One warp per row, 8 rows per block.
template <int kH, typename V, bool kInputLN>
__global__ void __launch_bounds__(256)
split_reduce(const float* __restrict__ partial, int slices, const mrd::bf16* __restrict__ z,
             const V* __restrict__ b, const V* __restrict__ gamma,
             const V* __restrict__ beta, const V* __restrict__ g0,
             const V* __restrict__ o0, mrd::bf16* __restrict__ y, int M, float eps) {
  const int lane = threadIdx.x % 32;
  const long long gr = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (gr >= M) return;
  // the form below spilled 4 bytes at H = 256 (V bf16, no LN0: K2 and K3)
  // and split_reduce_compact at 512 (ptxas on the H100's toolkit), so
  // 256 takes the compact form and 512 this one; the odd multiples of 128
  // have no whole 16-byte groups per lane and take the compact form too
  if constexpr (kH % 256 != 0 || kH == 256) {
    split_reduce_compact<kH, V, kInputLN>(partial, slices, z, b, gamma, beta, g0, o0, y, M, eps,
                                          gr, lane);
  } else {
    uint4 xg[kRowGroupsPerLane<kH>];
    load_x_row<kH, V, kInputLN>(z, gr, M, g0, o0, eps, lane, xg);
    float v[kRowGroupsPerLane<kH>][8];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kRowGroupsPerLane<kH>; ++j) {
      const int c = 8 * (lane + 32 * j);
      const float4* src = reinterpret_cast<const float4*>(partial + gr * kH + c);
      float4 lo = src[0], hi = src[1];
      for (int sl = 1; sl < slices; ++sl) {
        const float4* ps = reinterpret_cast<const float4*>(
            partial + (sl * static_cast<long long>(M) + gr) * kH + c);
        const float4 a = ps[0], bb = ps[1];
        lo = make_float4(lo.x + a.x, lo.y + a.y, lo.z + a.z, lo.w + a.w);
        hi = make_float4(hi.x + bb.x, hi.y + bb.y, hi.z + bb.z, hi.w + bb.w);
      }
      const float acc[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xg[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(xp[e]);
        v[j][2 * e] = acc[2 * e] + mrd::ld_f32(b + c + 2 * e) + xf.x;
        v[j][2 * e + 1] = acc[2 * e + 1] + mrd::ld_f32(b + c + 2 * e + 1) + xf.y;
        s += v[j][2 * e] + v[j][2 * e + 1];
      }
    }
    const float mu = mrd::warp_sum(s) * (1.0f / kH);
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < kRowGroupsPerLane<kH>; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) q += (v[j][e] - mu) * (v[j][e] - mu);
    const float rstd = rsqrtf(mrd::warp_sum(q) * (1.0f / kH) + eps);
#pragma unroll
    for (int j = 0; j < kRowGroupsPerLane<kH>; ++j) {
      const int c = 8 * (lane + 32 * j);
      uint4 out;
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cc = c + 2 * e;
        op[e] = __floats2bfloat162_rn(
            (v[j][2 * e] - mu) * rstd * mrd::ld_f32(gamma + cc) + mrd::ld_f32(beta + cc),
            (v[j][2 * e + 1] - mu) * rstd * mrd::ld_f32(gamma + cc + 1) +
                mrd::ld_f32(beta + cc + 1));
      }
      *reinterpret_cast<uint4*>(y + gr * kH + c) = out;
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major [rows, cols] matrix of `elem`-byte values,
// read (or written) in boxes of [box_rows, box_cols] in the 128-byte
// swizzle layout (box_cols * elem = 128), or the 64-byte one (box_cols *
// elem = 64). Rows past `rows` read as zeros and are not written.
bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                 int rows, int cols, int box_cols, int box_rows,
                 CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major bf16 [rows, cols] matrix in boxes of [box_rows, 64].
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  return make_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows, cols, 64, box_rows);
}

// A row-major f32 [rows, cols] matrix in boxes of [box_rows, 32].
bool make_map_f32(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  return make_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, rows, cols, 32, box_rows);
}

}  // namespace
