// Kernel W at the anisotropic BM3's physics, acha_box: the J.v of the
// Allen-Cahn + heat weak form with the four-fold a(theta) (phys_acha.cuh)
// over triangle boxes, (w, dt, v) -> (Jv_v, Jv_m), f32; fields (U, phi), the
// 4-point rule.
//
// Replaces, on the anisotropic bench3's outer Krylov J.v and exported A z
// (the 350^2 ffc3 grid), pfhubbenchmarks_tpu/ops/pallas_residual.py:
// make_pallas_jvp (:198) at this physics, which takes jax.jvp of the
// anisotropic terms in-kernel. The body is fem_tri_box.cuh's: each
// triangle's gradient of phi, its coefficients (Phys::tri) and its point
// tangents once, from the staged state planes; every node summed in the
// gather's order, so the gather's bits (acha_jvp.cu).

#include "fem_tri_box.cuh"
#include "phys_acha.cuh"

namespace {

// ach_box.cu's box: 7 x 15 vertices, 512 threads, three CTAs per SM
// (ops/tri_box.py TRI_BOX["acha"]; tools/torch_tri_box_probe.py)
using AchaBox = pfh::TriBox<7, 15, 3, 1>;

}  // namespace

// by, bx: the box the caller planned with (ops/tri_box.py TRI_BOX["acha"]).
PFH_EXPORT int pfh_acha_box(const float* params, int nq, int by, int bx,
                            const float* wv, const float* wm, const float* tv,
                            const float* tm, const float* bv, const float* bm,
                            const float* mask, float* ov, float* om, int ny,
                            int nx, void* stream) {
  return pfh::launch_tri_box<pfh::ACHA, AchaBox>(
      params, nq, by, bx, wv, wm, tv, tm, bv, bm, mask, ov, om, ny, nx,
      stream);
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of W
// (common.cuh kernel_info).
PFH_EXPORT int pfh_acha_box_info(int* out) {
  return pfh::tri_box_info<pfh::ACHA, AchaBox>(out);
}
