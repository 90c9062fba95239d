// The gather J.v at the anisotropic BM3's physics, acha_jvp: J.v of the
// Allen-Cahn + heat weak form with the four-fold a(theta) (phys_acha.cuh) on
// the crossed-P1 grid, (w, dt, v) -> (Jv_v, Jv_m), f32; fields (U, phi).
//
// Kernel G's form (ach_jvp.cu) at this physics: the level J.v whose launch
// record (ops/fem_jvp.GatherLaunch) the chain plans and kernel L read, and
// kernel W's comparison (acha_box.cu gives its bits). It replaces
// pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp (:198) at this
// physics where the J.v runs on its own. The gather body is fem_jvp.cuh's;
// the tangent reads the state's gradient, which the body forms in each
// triangle from the state slots it holds (no other loads).

#include "fem_jvp.cuh"
#include "phys_acha.cuh"

PFH_EXPORT int pfh_acha_jvp(const float* params, int nq, const float* wv,
                            const float* wm, const float* tv, const float* tm,
                            const float* bv, const float* bm, const float* mask,
                            float* ov, float* om, int ny, int nx, void* stream) {
  return pfh::launch_fem_jvp<pfh::ACHA>(params, nq, wv, wm, tv, tm, bv, bm,
                                        mask, ov, om, ny, nx, stream);
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM at nq
// points (common.cuh kernel_info).
PFH_EXPORT int pfh_acha_jvp_info(int nq, int* out) {
  if (nq == 3)
    return pfh::kernel_info(pfh::fem_jvp_kernel<pfh::ACHA, 3>, pfh::kThreads,
                            0, out);
  if (nq == 4)
    return pfh::kernel_info(pfh::fem_jvp_kernel<pfh::ACHA, 4>, pfh::kThreads,
                            0, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
