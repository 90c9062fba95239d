// Kernel W, the triangle-box J.v (fem_tri_box.cuh), at BM6's Cahn-Hilliard +
// Poisson (phys_chp.cuh) with the Dirichlet rows of phi: the masked store of
// jvp_store (kMask), so E's bits. bench6's outer Krylov J.v, in place of
// kernel E (chp_jvp.cu), which stays its comparison and the gather kernel of
// the multigrid levels. The box is chosen by tools/torch_tri_box_probe.py
// (kind "chp"): NS = 1 state plane and 3 tangent planes staged, 576 B of
// terms a cell.

#include "fem_tri_box.cuh"
#include "phys_chp.cuh"

namespace {

using ChpBox = pfh::TriBox<7, 7, 2, 1>;

}  // namespace

PFH_EXPORT int pfh_chp_box(const float* params, int nq, int by, int bx,
                           const float* wv, const float* wm, const float* tv,
                           const float* tm, const float* bv, const float* bm,
                           const float* mask, float* ov, float* om, int ny,
                           int nx, void* stream) {
  return pfh::launch_tri_box<pfh::CHP, ChpBox, true>(
      params, nq, by, bx, wv, wm, tv, tm, bv, bm, mask, ov, om, ny, nx,
      stream);
}

PFH_EXPORT int pfh_chp_box_info(int* out) {
  return pfh::tri_box_info<pfh::CHP, ChpBox, true>(out);
}
