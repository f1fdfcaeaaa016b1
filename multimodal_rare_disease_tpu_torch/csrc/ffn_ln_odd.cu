// K1 and K2 in bf16 at the odd multiples of 128 below 1,024: the C entries
// of ffn_ln.cuh's kernel at H = 384 (microsoft/MiniLM-L12-H384), 640 and
// 896, `name`_h<H> as ffn_ln.cu's. A source of its own, so that nvcc
// compiles these instances in parallel with ffn_ln.cu's.

#include "ffn_ln.cuh"

extern "C" {

MRD_FFN_WIDTH(384)
MRD_FFN_WIDTH(640)
MRD_FFN_WIDTH(896)

}  // extern "C"
