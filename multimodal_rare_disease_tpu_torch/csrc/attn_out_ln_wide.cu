// K3 in bf16 above BERT-large width: the C entries of attn_out_ln.cuh's
// kernel at H = 1,152, 1,280, 1,408 and 1,536 (the pair with ctx streamed
// through a ring), `name`_h<H> as attn_out_ln.cu's. A source of its own, so
// that nvcc compiles these instances in parallel with the other widths'.

#include "attn_out_ln.cuh"

extern "C" {

MRD_ATTN_OUT_WIDTH(1152)
MRD_ATTN_OUT_WIDTH(1280)
MRD_ATTN_OUT_WIDTH(1408)
MRD_ATTN_OUT_WIDTH(1536)

}  // extern "C"
