// Helpers shared by the port's row-tile kernels (ffn_ln.cuh, attn_out_ln.cuh):
// warp reductions, 16-byte cp.async copies into shared memory with group
// commit/wait (the weight ring), and loads of the bias / LayerNorm vectors as
// f32 or bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace mrd {

using bf16 = __nv_bfloat16;

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }
constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ld_f32(const float* p) { return *p; }
__device__ __forceinline__ float ld_f32(const bf16* p) { return __bfloat162float(*p); }

}  // namespace mrd
