// K1 and K2 in bf16 at H = 1,408 and 1,536 (microsoft/deberta-v2-xlarge's
// width): the C entries of ffn_ln.cuh's kernel, `name`_h<H> as
// ffn_ln.cu's; a source of its own beside ffn_ln_wide.cu (1,152 and
// 1,280), so that nvcc compiles the two in parallel.

#include "ffn_ln.cuh"

extern "C" {

MRD_FFN_WIDTH(1408)
MRD_FFN_WIDTH(1536)

}  // extern "C"
