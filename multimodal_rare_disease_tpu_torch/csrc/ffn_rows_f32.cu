// K1-f32 and K2-f32's one-pass form at H = 128 and 256 (ffn_rows_f32.cuh) in
// a source of its own, so that its nvcc runs beside ffn_ln_f32.cu's (as the
// bf16 FFN's widths are spread over four sources): its four kernels are the
// longest compile of the build (51.6 s in all on the H100's machine, 34.0 s
// before them, PERF.md). ffn_ln_f32.cu's C entries call
// mrd::ffn_rows_launch when `slices` is 0.

#include <cuda.h>

#include "ffn_rows_f32.cuh"

namespace mrd {

// launch_ffn_rows<h, input_ln> (ffn_rows_f32.cuh) at h = 128 or 256
cudaError_t ffn_rows_launch(int h, bool input_ln, const float* z, const float* w1t,
                            const float* b1, const float* w2t, const float* b2,
                            const float* gamma, const float* beta, const float* g0,
                            const float* o0, float* y, float* scratch, int M, int F, float eps,
                            cudaStream_t stream) {
  const auto launch = h == 128 ? (input_ln ? launch_ffn_rows<128, true>
                                           : launch_ffn_rows<128, false>)
                               : (input_ln ? launch_ffn_rows<256, true>
                                           : launch_ffn_rows<256, false>);
  if (h != 128 && h != 256) return cudaErrorInvalidValue;
  return launch(z, w1t, b1, w2t, b2, gamma, beta, g0, o0, y, scratch, M, F, eps, stream);
}

}  // namespace mrd
