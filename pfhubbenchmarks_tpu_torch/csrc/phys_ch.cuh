// BM1's mixed Cahn-Hilliard physics on (c, mu), for every kernel family:
// the pointwise tangent (kernel A, ch_jvp.cu, and the tile kernels,
// ch_tile.cu) and the pointwise residual terms (kernel R, ch_residual.cu).
// Mirrors benchmarks/bench1.py: terms_tangent and terms.
#pragma once

#include "fem_params.cuh"

namespace pfh {

// constants k[]: M, kappa, rho_s, c_alpha, c_beta
//   src_c  = (c - c0) / dt          flux_c  = M grad(mu)
//   src_mu = mu - f'(c)             flux_mu = -kappa grad(c)
// with f'(c) = 2 rho_s (c - c_a)(c_b - c)((c_b - c) - (c - c_a)); its tangent
//   d src_c  = dc / dt             d flux_c  = M grad(dmu)
//   d src_mu = dmu - f''(c) dc     d flux_mu = -kappa grad(dc)
struct CH {
  static constexpr int NF = 2;
  static constexpr int NS = 1;  // the tangent reads c only
  __host__ __device__ static constexpr int state_field(int) { return 0; }
  __device__ __forceinline__ static void tangent(
      const JvpParams& P, const float (&u)[NS], const float (&d)[NF],
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
  // u, gx, gy: every field at the point; u0: the previous time level
  __device__ __forceinline__ static void residual(
      const JvpParams& P, const float (&u)[NF], const float (&gx)[NF],
      const float (&gy)[NF], const float (&u0)[NF], float (&src)[NF],
      float (&fx)[NF], float (&fy)[NF]) {
    const float M = P.k[0], kappa = P.k[1], rho_s = P.k[2];
    const float c = u[0];
    const float a = c - P.k[3];
    const float b = P.k[4] - c;
    src[0] = (c - u0[0]) / P.dt;
    fx[0] = M * gx[1];
    fy[0] = M * gy[1];
    src[1] = u[1] - 2.0f * rho_s * a * b * (b - a);
    fx[1] = -kappa * gx[0];
    fy[1] = -kappa * gy[0];
  }
};

}  // namespace pfh
