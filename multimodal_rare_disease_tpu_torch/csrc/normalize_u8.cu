// K4: the fused uint8 ImageNet normalize, written by hand for Hopper (sm_90a):
//
//   y[i] = f32(u[i]) * scale[c] + bias[c],   c = i mod 3 (NHWC, 3 channels)
//   scale[c] = 1 / (255 std[c]),  bias[c] = -mean[c] / std[c]   (f32, from
//   the wrapper), y in f32 or rounded once to bf16
//
// Replaces multimodal_rare_disease_tpu/ops/pallas/image_kernels.py::
// _normalize_kernel (reached through _fused_normalize_impl and
// fused_normalize_u8), in its FMA form. The product and the sum are each
// rounded to f32 (__fmul_rn, __fadd_rn: no contraction into one fma), as
// the plain version in kernels/image.py computes them, so the two agree
// bit for bit.
//
// What bounds it on the H100: it is elementwise, with 2 operations per
// element against 3 (bf16 out) or 5 (f32 out) bytes moved, so device memory
// bounds it: at 256 images of 256 x 256 px, 50.3 MB in and 100.7 MB out in
// bf16 take 0.045 ms at 3.35 TB/s. The design moves each byte once, in
// 16-byte accesses: a thread loads 16 uint8 with one vector load and stores
// 16 outputs with two (bf16) or four (f32) 16-byte stores; the channel of
// each element follows from its flat index, so no channel-indexed layout is
// needed (the TPU kernel tiled the rows instead). A grid-stride loop covers
// any size; the last N mod 16 elements are done one per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kVec = 16;  // uint8 elements per vector load

struct Affine {
  float scale[3];
  float bias[3];
};

__device__ __forceinline__ float affine(const Affine& a, int c, float u) {
  const float s = c == 0 ? a.scale[0] : (c == 1 ? a.scale[1] : a.scale[2]);
  const float b = c == 0 ? a.bias[0] : (c == 1 ? a.bias[1] : a.bias[2]);
  return __fadd_rn(__fmul_rn(u, s), b);
}

__device__ __forceinline__ void store16(float* dst, const float (&v)[kVec]) {
#pragma unroll
  for (int i = 0; i < kVec; i += 4)
    *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

__device__ __forceinline__ void store16(bf16* dst, const float (&v)[kVec]) {
  uint32_t w[kVec / 2];
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(bf16* dst, float v) { *dst = __float2bfloat16(v); }

// T: the output type (float or bf16). `in` and `out` are 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
normalize_u8_kernel(const uint8_t* __restrict__ in, T* __restrict__ out, long long n,
                    Affine a) {
  const long long n_vec = n / kVec;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = tid; g < n_vec; g += stride) {
    const long long base = g * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(in + base);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    int c = static_cast<int>(base % 3);
    float v[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const uint32_t u = (words[i / 4] >> (8 * (i % 4))) & 0xffu;  // little endian
      v[i] = affine(a, c, static_cast<float>(u));
      c = c == 2 ? 0 : c + 1;
    }
    store16(out + base, v);
  }
  // the ragged tail (fewer than 16 elements), one per thread
  const long long i = n_vec * kVec + tid;
  if (i < n) store1(out + i, affine(a, static_cast<int>(i % 3), static_cast<float>(in[i])));
}

template <typename T>
cudaError_t launch(const void* in, void* out, long long n, const Affine& a,
                   int sm_count, cudaStream_t stream) {
  const long long n_vec = n / kVec;
  // enough blocks to fill the card a few times over; the loop covers the rest
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 8LL * sm_count) blocks = 8LL * sm_count;
  if (blocks < 1) blocks = 1;
  normalize_u8_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<T*>(out), n, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = u * scale[c] + bias[c] over n uint8 elements of NHWC images with 3
// channels, c = flat index mod 3, on `stream`. `in` and `out` are device
// pointers, 16-byte aligned; out is f32, or bf16 when out_bf16 is non-zero.
// Returns the cudaError_t of the launch (0 on success). Allocates nothing.
int mrd_normalize_u8(const void* in, void* out, long long n, const float* scale,
                     const float* bias, int out_bf16, int sm_count, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  Affine a;
  for (int c = 0; c < 3; ++c) {
    a.scale[c] = scale[c];
    a.bias[c] = bias[c];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_bf16 ? launch<bf16>(in, out, n, a, sm_count, s)
                                   : launch<float>(in, out, n, a, sm_count, s));
}

}  // extern "C"
