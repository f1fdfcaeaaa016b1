// The residual row of the port's f32 kernels, with LN0 for K1: the split
// and reduce passes of ffn_ln_f32.cu and the reduce pass of
// attn_out_ln_f32.cu (gemm_tf32x3.cuh) read it. A template over the hidden
// width kH (768 for BERT-base, 1,024 for BERT-large, 512, 256 and 128 for
// the compact BERTs, 384 for MiniLM, 640 and 896, and 1,152 to 1,536; any
// multiple of 128).
// Everything is in f32 (LN0 two-pass) and in an anonymous namespace: each
// source that includes it gets its own copy.

#pragma once

#include "common.cuh"

namespace {

// float4s per lane of a kH-wide row: 6 at 768, 8 at 1,024, 1 at 128
template <int kH>
constexpr int kF32RowVecs = kH / 4 / 32;

// Row `gr` of z as kF32RowVecs<kH> float4s per lane (columns 4 (lane +
// 32 j) .. + 4): LN0 of z (two-pass statistics, K1) or z itself (K2, K3);
// zeros past M. One warp per row; the FFN's split pass and its LayerNorm pass both take x
// from here, so they see the same bits.
template <int kH, bool kInputLN>
__device__ __forceinline__ void load_row_f32(const float* __restrict__ z, long long gr, int M,
                                             const float* __restrict__ g0,
                                             const float* __restrict__ o0, float eps, int lane,
                                             float4 (&out)[kF32RowVecs<kH>]) {
  static_assert(kH % 128 == 0, "whole float4s per lane");
  if (gr >= M) {
#pragma unroll
    for (int j = 0; j < kF32RowVecs<kH>; ++j) out[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float4* src = reinterpret_cast<const float4*>(z + gr * kH);
#pragma unroll
  for (int j = 0; j < kF32RowVecs<kH>; ++j) out[j] = src[lane + 32 * j];
  if constexpr (kInputLN) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kF32RowVecs<kH>; ++j) s += (out[j].x + out[j].y) + (out[j].z + out[j].w);
    const float mu = mrd::warp_sum(s) * (1.0f / kH);
    float q = 0.0f;
#pragma unroll
    for (int j = 0; j < kF32RowVecs<kH>; ++j) {
      const float4 d = make_float4(out[j].x - mu, out[j].y - mu, out[j].z - mu, out[j].w - mu);
      q += (d.x * d.x + d.y * d.y) + (d.z * d.z + d.w * d.w);
    }
    const float rstd = rsqrtf(mrd::warp_sum(q) * (1.0f / kH) + eps);
#pragma unroll
    for (int j = 0; j < kF32RowVecs<kH>; ++j) {
      const int c = 4 * (lane + 32 * j);
      const float4 g = *reinterpret_cast<const float4*>(g0 + c);
      const float4 o = *reinterpret_cast<const float4*>(o0 + c);
      out[j] = make_float4((out[j].x - mu) * rstd * g.x + o.x, (out[j].y - mu) * rstd * g.y + o.y,
                           (out[j].z - mu) * rstd * g.z + o.z, (out[j].w - mu) * rstd * g.w + o.w);
    }
  }
}

}  // namespace
