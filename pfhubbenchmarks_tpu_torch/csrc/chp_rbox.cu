// The residual box at BM6's physics, chp_rbox: the f32 residual of the
// Cahn-Hilliard + Poisson weak form over triangle boxes, (w, w0, dt) -> R,
// fields (c, mu, phi), with phi's Dirichlet rows u - g; the 4-point rule.
//
// Replaces, on bench6's cp line search (the 100^2 ffc3 grid), kernel R
// (chp_residual.cu), and with it
// pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_residual (:226) at
// BM6's physics. The body is fem_tri_box.cuh's residual_box_kernel, the
// terms phys_chp.cuh's; R stays built as its comparison.
//
// What bounds it on the H100: at BM6's 100^2 one launch reads ~0.7 MB (6
// planes of 20,201 nodes, the mask and g) and writes 0.24 MB: bytes, 0.242
// us. A 7 x 7 box stages 6 planes and 576 B of terms a cell: ~40 KB.

#include "fem_tri_box.cuh"
#include "phys_chp.cuh"

namespace {

using ChpRBox = pfh::TriBox<7, 7, 2, 1>;

}  // namespace

// mask, gv: the Dirichlet planes (ops/fem_residual.dirichlet_planes), both
// null or both given; by, bx: the box the caller planned with
// (ops/residual_box.py RESIDUAL_BOX["chp"]).
PFH_EXPORT int pfh_chp_rbox(const float* params, int nq, int by, int bx,
                            const float* wv, const float* wm,
                            const float* w0v, const float* w0m,
                            const float* mask, const float* gv, float* ov,
                            float* om, int ny, int nx, void* stream) {
  return pfh::launch_residual_box<pfh::CHP, ChpRBox>(
      params, nq, by, bx, wv, wm, w0v, w0m, mask, gv, ov, om, ny, nx, stream);
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of the
// residual box (common.cuh kernel_info).
PFH_EXPORT int pfh_chp_rbox_info(int* out) {
  return pfh::residual_box_info<pfh::CHP, ChpRBox>(out);
}
