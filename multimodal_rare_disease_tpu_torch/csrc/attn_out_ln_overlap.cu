// K3 in bf16 at H = 128 and 640: the C entries of attn_out_ln.cuh's kernels
// at these widths, `name`_h<H> as attn_out_ln.cu's: at 640 with its
// overlapped form (`slices` 0), persistent clusters of two blocks of 128
// rows by 320 columns on n160 Wo tiles (attn_out_quad_kernel<640>); at 128
// the tile form alone, several blocks an SM with x loaded up front
// (attn_out_tile_kernel<128>). A source of its own, so that nvcc compiles
// these instances in parallel with the other widths'.

#include "attn_out_ln.cuh"

extern "C" {

MRD_ATTN_OUT_WIDTH(128)
MRD_ATTN_OUT_WIDTH(640)

}  // extern "C"
