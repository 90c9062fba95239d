// Kernel E, chp_jvp: J.v of BM6's Cahn-Hilliard + Poisson weak form on the
// crossed-P1 grid, (w, dt, v) -> (Jv_v, Jv_m), f32; fields (c, mu, phi), with
// the Dirichlet rows of phi given as a 0/1 vertex mask.
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp at
// BM6's physics (the outer Krylov matvec, its BC rows re-set after the
// kernel at benchmarks/base.py:201-215) and the in-kernel A.z with edge
// masks of pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_descend_chain
// and make_fused_ascend_chain. The gather body is fem_jvp.cuh's; this file
// supplies BM6's pointwise tangent (the mirror of
// benchmarks/bench6.py:terms_tangent).
//
// What bounds it on the H100: at BM6's 100^2 one launch reads ~0.6 MB (c,
// three tangent fields, an optional b and mask; 20,201 nodes per field) and
// writes 0.24 MB, all of it L2-resident, so a launch is latency-bound like
// kernel A's: one launch per J.v, one wave of ~160 blocks.

#include "fem_jvp.cuh"

namespace {

// constants k[]: M, kappa, rho, c_alpha, c_beta, k, epsilon
//   d src_c   = dc / dt                      d flux_c   = M grad(dmu)
//   d src_mu  = dmu - f''(c) dc - k dphi     d flux_mu  = -kappa grad(dc)
//   d src_phi = k dc / epsilon               d flux_phi = -grad(dphi)
// with f_chem = rho (c - c_a)^2 (c_b - c)^2.
struct CHP {
  static constexpr int NF = 3;
  static constexpr int NS = 1;  // the tangent reads c only
  __host__ __device__ static constexpr int state_field(int) { return 0; }
  __device__ __forceinline__ static void tangent(
      const pfh::JvpParams& P, const float (&u)[NS], const float (&d)[NF],
      const float (&gx)[NF], const float (&gy)[NF], float (&src)[NF],
      float (&fx)[NF], float (&fy)[NF]) {
    const float M = P.k[0], kappa = P.k[1], rho = P.k[2];
    const float kk = P.k[5], eps = P.k[6];
    const float c = u[0];
    const float a = c - P.k[3];
    const float b = P.k[4] - c;
    const float fpp = 2.0f * rho * ((b - a) * (b - a) - 2.0f * a * b);
    src[0] = d[0] / P.dt;
    fx[0] = M * gx[1];
    fy[0] = M * gy[1];
    src[1] = d[1] - fpp * d[0] - kk * d[2];
    fx[1] = -kappa * gx[0];
    fy[1] = -kappa * gy[0];
    src[2] = kk * d[0] / eps;
    fx[2] = -gx[2];
    fy[2] = -gy[2];
  }
};

}  // namespace

PFH_EXPORT int pfh_chp_jvp(const float* params, int nq, const float* wv,
                           const float* wm, const float* tv, const float* tm,
                           const float* bv, const float* bm, const float* mask,
                           float* ov, float* om, int ny, int nx, void* stream) {
  return pfh::launch_fem_jvp<CHP>(params, nq, wv, wm, tv, tm, bv, bm, mask, ov,
                                  om, ny, nx, stream);
}
