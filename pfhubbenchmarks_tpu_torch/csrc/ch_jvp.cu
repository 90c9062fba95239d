// Kernel A, ch_jvp: J.v of BM1's mixed Cahn-Hilliard weak form on the
// crossed-P1 grid, (w, dt, v) -> (Jv_v, Jv_m), f32; fields (c, mu).
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp (the
// outer Krylov matvec) and the in-kernel A.z of
// pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_vcycle (per-level
// smoothing and residual J.v, and the exported true-rule pair). The gather
// body is fem_jvp.cuh's; this file supplies BM1's pointwise tangent (the
// mirror of benchmarks/bench1.py:terms_tangent). It does not depend on the
// previous time level, so w0 is not an argument.
//
// What bounds it on the H100: at BM1's 100^2 one launch reads ~0.5 MB and
// does ~20 MFLOP, all of it L2-resident (the whole hierarchy is a few MB of
// the 50 MB L2), so a launch is latency-bound (launch + one wave of ~160
// blocks). The design keeps it to ONE launch per J.v.

#include "fem_jvp.cuh"

namespace {

// constants k[]: M, kappa, rho_s, c_alpha, c_beta
//   d src_c  = dc / dt             d flux_c  = M grad(dmu)
//   d src_mu = dmu - f''(c) dc     d flux_mu = -kappa grad(dc)
// with f'(c) = 2 rho_s (c - c_a)(c_b - c)((c_b - c) - (c - c_a)).
struct CH {
  static constexpr int NF = 2;
  static constexpr int NS = 1;  // the tangent reads c only
  __host__ __device__ static constexpr int state_field(int) { return 0; }
  __device__ __forceinline__ static void tangent(
      const pfh::JvpParams& P, const float (&u)[NS], const float (&d)[NF],
      const float (&gx)[NF], const float (&gy)[NF], float (&src)[NF],
      float (&fx)[NF], float (&fy)[NF]) {
    const float M = P.k[0], kappa = P.k[1], rho_s = P.k[2];
    const float c = u[0];
    const float a = c - P.k[3];
    const float b = P.k[4] - c;
    const float fpp = 2.0f * rho_s * ((b - a) * (b - a) - 2.0f * a * b);
    src[0] = d[0] / P.dt;
    fx[0] = M * gx[1];
    fy[0] = M * gy[1];
    src[1] = d[1] - fpp * d[0];
    fx[1] = -kappa * gx[0];
    fy[1] = -kappa * gy[0];
  }
};

}  // namespace

PFH_EXPORT int pfh_jvp_param_floats() { return pfh::kJvpParamFloats; }

PFH_EXPORT int pfh_ch_jvp(const float* params, int nq, const float* wv,
                          const float* wm, const float* tv, const float* tm,
                          const float* bv, const float* bm, const float* mask,
                          float* ov, float* om, int ny, int nx, void* stream) {
  return pfh::launch_fem_jvp<CH>(params, nq, wv, wm, tv, tm, bv, bm, mask, ov,
                                 om, ny, nx, stream);
}
