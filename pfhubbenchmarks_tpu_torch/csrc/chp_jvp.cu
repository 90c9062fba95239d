// Kernel E, chp_jvp: J.v of BM6's Cahn-Hilliard + Poisson weak form on the
// crossed-P1 grid, (w, dt, v) -> (Jv_v, Jv_m), f32; fields (c, mu, phi), with
// the Dirichlet rows of phi given as a 0/1 vertex mask.
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp at
// BM6's physics (the outer Krylov matvec, its BC rows re-set after the
// kernel at benchmarks/base.py:201-215) and the in-kernel A.z with edge
// masks of pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_descend_chain
// and make_fused_ascend_chain. The gather body is fem_jvp.cuh's; the
// pointwise tangent is BM6's (the mirror of
// benchmarks/bench6.py:terms_tangent), from phys_chp.cuh.
//
// What bounds it on the H100: at BM6's 100^2 one launch reads ~0.6 MB (c,
// three tangent fields, an optional b and mask; 20,201 nodes per field) and
// writes 0.24 MB, all of it L2-resident, so a launch is latency-bound like
// kernel A's: one launch per J.v, one wave of ~160 blocks.

#include "fem_jvp.cuh"
#include "phys_chp.cuh"

PFH_EXPORT int pfh_chp_jvp(const float* params, int nq, const float* wv,
                           const float* wm, const float* tv, const float* tm,
                           const float* bv, const float* bm, const float* mask,
                           float* ov, float* om, int ny, int nx, void* stream) {
  return pfh::launch_fem_jvp<pfh::CHP>(params, nq, wv, wm, tv, tm, bv, bm, mask, ov,
                                  om, ny, nx, stream);
}
