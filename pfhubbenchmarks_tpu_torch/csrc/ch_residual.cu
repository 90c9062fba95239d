// Kernel R at BM1's physics (residual, fields c, mu): the f32 residual
// body of fem_residual.cuh with phys_ch.cuh's terms. Replaces
// pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_residual; see
// fem_residual.cuh for the design and what bounds it.

#include "fem_residual.cuh"
#include "phys_ch.cuh"

PFH_EXPORT int pfh_ch_residual(const float* params, int nq, const float* wv,
                               const float* wm, const float* w0v,
                               const float* w0m, const float* mask,
                               const float* gv, float* ov, float* om, int ny,
                               int nx, void* stream) {
  return pfh::launch_fem_residual<pfh::CH>(params, nq, wv, wm, w0v, w0m, mask,
                                           gv, ov, om, ny, nx, stream);
}
