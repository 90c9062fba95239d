// The residual box at BM2's physics, chac_rbox: the f32 residual of the
// Cahn-Hilliard + NE Allen-Cahn weak form over triangle boxes, (w, w0, dt)
// -> R, fields (c, mu, eta_1..eta_NE), NE in {1, 2, 4}, the 4-point rule,
// no Dirichlet rows.
//
// Replaces, on the cp line search of bench2 and bench2_eta1 (the 100^2 ffc3
// grid), kernel R (chac_residual.cu), and with it
// pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_residual (:226) at
// BM2's physics. The body is fem_tri_box.cuh's residual_box_kernel, the
// terms phys_chac.cuh's; R stays built as its comparison.
//
// What bounds it on the H100: f32 operations, 0.728 us at NE 4 (each of the
// 10,000 x 4 x 4 point residuals once, x 1.31 for the halo, where R
// evaluated each three times); one launch reads ~1.0 MB (12 planes of
// 20,201 nodes) and writes 0.5 MB. At NE 4 a 7 x 7 box stages 12 planes of
// 145 floats and 1,152 B of terms a cell: ~80 KB, two CTAs per SM, as W's
// ChacBox.

#include "fem_tri_box.cuh"
#include "phys_chac.cuh"

namespace {

using ChacRBox = pfh::TriBox<7, 7, 2, 1>;

template <int NE>
int launch_ne(const float* params, int nq, int by, int bx, const float* wv,
              const float* wm, const float* w0v, const float* w0m,
              const float* mask, const float* gv, float* ov, float* om,
              int ny, int nx, void* stream) {
  return pfh::launch_residual_box<pfh::CHAC<NE, false>, ChacRBox>(
      params, nq, by, bx, wv, wm, w0v, w0m, mask, gv, ov, om, ny, nx, stream);
}

}  // namespace

// ne: the number of Allen-Cahn fields (1, 2 or 4); by, bx: the box the
// caller planned with (ops/residual_box.py RESIDUAL_BOX["chac"]).
PFH_EXPORT int pfh_chac_rbox(const float* params, int nq, int ne, int by,
                             int bx, const float* wv, const float* wm,
                             const float* w0v, const float* w0m,
                             const float* mask, const float* gv, float* ov,
                             float* om, int ny, int nx, void* stream) {
  switch (ne) {
    case 1:
      return launch_ne<1>(params, nq, by, bx, wv, wm, w0v, w0m, mask, gv, ov,
                          om, ny, nx, stream);
    case 2:
      return launch_ne<2>(params, nq, by, bx, wv, wm, w0v, w0m, mask, gv, ov,
                          om, ny, nx, stream);
    case 4:
      return launch_ne<4>(params, nq, by, bx, wv, wm, w0v, w0m, mask, gv, ov,
                          om, ny, nx, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of the
// residual box at ne order parameters (common.cuh kernel_info).
PFH_EXPORT int pfh_chac_rbox_info(int ne, int* out) {
  switch (ne) {
    case 1: return pfh::residual_box_info<pfh::CHAC<1, false>, ChacRBox>(out);
    case 2: return pfh::residual_box_info<pfh::CHAC<2, false>, ChacRBox>(out);
    case 4: return pfh::residual_box_info<pfh::CHAC<4, false>, ChacRBox>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
