// K1 and K2 in bf16 above BERT-large width: the C entries of ffn_ln.cuh's
// kernel at H = 1,152 and 1,280 (the pair that splits x by output
// halves), `name`_h<H> as ffn_ln.cu's; 1,408 and 1,536 are in
// ffn_ln_wide2.cu. Sources of their own, so that nvcc compiles these
// instances in parallel with the other widths' (with one source of all
// four the build took 42.7 s on the H100's host, with two 33.8 s).

#include "ffn_ln.cuh"

extern "C" {

MRD_FFN_WIDTH(1152)
MRD_FFN_WIDTH(1280)

}  // extern "C"
