// K1 and K2 in bf16: the C entries of ffn_ln.cuh's kernel at H = 768 and
// at 128, 256, 512 and 1,024; the odd multiples of 128 (384, 640, 896)
// are in ffn_ln_odd.cu, the widths above 1,024 in ffn_ln_wide.cu and
// ffn_ln_wide2.cu.

#include "ffn_ln.cuh"

extern "C" {

// Dynamic shared memory per block of the FFN kernel (H = 768; the other
// widths' entries below).
int mrd_ffn_smem_bytes() { return static_cast<int>(Ffn<768>::kSmemBytes); }

// The clusters the card holds at once (0: H = 768 launches no cluster; the
// pair widths' entries below).
int mrd_ffn_max_clusters() { return max_clusters<768>(); }

const char* mrd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1: y = LN2(x + GELU(x W1 + b1) W2 + b2), x = LN0(z), on `stream`.
// Pointers are device pointers, 16-byte aligned; w1t is [F, H] and w2t is
// [H, F], row-major, H = 768. The six vectors are f32, or bf16 when
// vec_bf16 is non-zero. `slices` > 1 splits F into that many slices (F a
// multiple of 64 * slices) and needs `scratch`, f32 [slices, M, H]. Returns
// the cudaError_t of the launches (0 on success). Allocates nothing.
int mrd_ffn_pre_ln_bf16(const void* z, const void* w1t, const void* b1,
                        const void* w2t, const void* b2, const void* gamma,
                        const void* beta, const void* g0, const void* o0,
                        void* y, void* scratch, int M, int F, int slices, float eps,
                        int vec_bf16, void* stream) {
  return pre_ln_bf16<768>(z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y, scratch, M, F, slices,
                          eps, vec_bf16, stream);
}

// K2: y = LN(x + GELU(x W1 + b1) W2 + b2) with x the input rows as they are,
// on `stream`. Arguments as mrd_ffn_pre_ln_bf16 without the LN0 vectors; the
// four vectors are bf16.
int mrd_ffn_ln_bf16(const void* x, const void* w1t, const void* b1, const void* w2t,
                    const void* b2, const void* gamma, const void* beta, void* y,
                    void* scratch, int M, int F, int slices, float eps, void* stream) {
  return ln_bf16<768>(x, w1t, b1, w2t, b2, gamma, beta, y, scratch, M, F, slices, eps,
                      stream);
}

MRD_FFN_WIDTH(128)
MRD_FFN_WIDTH(256)
MRD_FFN_WIDTH(512)
MRD_FFN_WIDTH(1024)

}  // extern "C"
