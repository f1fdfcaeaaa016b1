// K3 in bf16: the C entries of attn_out_ln.cuh's kernel at H = 768 and at
// 256, 384, 512, 896 and 1,024; the widths above 1,024 are in
// attn_out_ln_wide.cu, 128 and 640 (with their overlapped forms) in
// attn_out_ln_overlap.cu.

#include "attn_out_ln.cuh"

extern "C" {

// Dynamic shared memory per block of the attention-output kernel (H = 768;
// the other widths' entries below).
int mrd_attn_out_smem_bytes() { return static_cast<int>(AttnOut<768>::kSmemBytes); }

// y = LN(x + ctx Wo^T + bo) on `stream`. Pointers are device pointers,
// 16-byte aligned; ctx, x and y are [M, 768] row-major, wo is [768 out,
// 768 in] row-major, bo, gamma and beta are [768]; all bf16. `slices` > 1
// splits the 12 k chunks into that many slices (a divisor of 12) and needs
// `scratch`, f32 [slices, M, 768]. Returns the cudaError_t of the launches
// (0 on success). Allocates nothing.
int mrd_attn_out_ln_bf16(const void* ctx, const void* x, const void* wo, const void* bo,
                         const void* gamma, const void* beta, void* y, void* scratch, int M,
                         int slices, float eps, void* stream) {
  return attn_out_ln_bf16<768>(ctx, x, wo, bo, gamma, beta, y, scratch, M, slices, eps, stream);
}

MRD_ATTN_OUT_WIDTH(256)
MRD_ATTN_OUT_WIDTH(384)
MRD_ATTN_OUT_WIDTH(512)
MRD_ATTN_OUT_WIDTH(896)
MRD_ATTN_OUT_WIDTH(1024)

}  // extern "C"
