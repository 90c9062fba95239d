// Kernel R at BM2's physics (residual, fields c, mu, eta_1..eta_NE with NE
// in {1, 2, 4}): the f32 residual body of fem_residual.cuh with
// phys_chac.cuh's coupled terms. Replaces
// pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_residual; see
// fem_residual.cuh for the design and what bounds it.

#include "fem_residual.cuh"
#include "phys_chac.cuh"

// ne: the number of Allen-Cahn fields (1, 2 or 4)
PFH_EXPORT int pfh_chac_residual(const float* params, int nq, int ne,
                                 const float* wv, const float* wm,
                                 const float* w0v, const float* w0m,
                                 const float* mask, const float* gv, float* ov,
                                 float* om, int ny, int nx, void* stream) {
  switch (ne) {
    case 1:
      return pfh::launch_fem_residual<pfh::CHAC<1, false>>(
          params, nq, wv, wm, w0v, w0m, mask, gv, ov, om, ny, nx, stream);
    case 2:
      return pfh::launch_fem_residual<pfh::CHAC<2, false>>(
          params, nq, wv, wm, w0v, w0m, mask, gv, ov, om, ny, nx, stream);
    case 4:
      return pfh::launch_fem_residual<pfh::CHAC<4, false>>(
          params, nq, wv, wm, w0v, w0m, mask, gv, ov, om, ny, nx, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
