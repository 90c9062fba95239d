// BM6's Cahn-Hilliard + Poisson physics on (c, mu, phi), for every kernel
// family: the pointwise tangent (kernel E, chp_jvp.cu) and the pointwise
// residual terms (kernel R, chp_residual.cu). Mirrors
// benchmarks/bench6.py: terms_tangent and terms.
#pragma once

#include "fem_params.cuh"

namespace pfh {

// constants k[]: M, kappa, rho, c_alpha, c_beta, k, epsilon
//   src_c   = (c - c0) / dt              flux_c   = M grad(mu)
//   src_mu  = mu - f'(c) - k phi         flux_mu  = -kappa grad(c)
//   src_phi = k c / epsilon              flux_phi = -grad(phi)
// with f_chem = rho (c - c_a)^2 (c_b - c)^2; its tangent
//   d src_c   = dc / dt                      d flux_c   = M grad(dmu)
//   d src_mu  = dmu - f''(c) dc - k dphi     d flux_mu  = -kappa grad(dc)
//   d src_phi = k dc / epsilon               d flux_phi = -grad(dphi)
struct CHP {
  static constexpr int NF = 3;
  static constexpr int NS = 1;  // the tangent reads c only
  __host__ __device__ static constexpr int state_field(int) { return 0; }
  __device__ __forceinline__ static void tangent(
      const JvpParams& P, const float (&u)[NS], const float (&d)[NF],
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
  __device__ __forceinline__ static void residual(
      const JvpParams& P, const float (&u)[NF], const float (&gx)[NF],
      const float (&gy)[NF], const float (&u0)[NF], float (&src)[NF],
      float (&fx)[NF], float (&fy)[NF]) {
    const float M = P.k[0], kappa = P.k[1], rho = P.k[2];
    const float kk = P.k[5], eps = P.k[6];
    const float c = u[0];
    const float a = c - P.k[3];
    const float b = P.k[4] - c;
    src[0] = (c - u0[0]) / P.dt;
    fx[0] = M * gx[1];
    fy[0] = M * gy[1];
    src[1] = u[1] - (2.0f * rho * a * b * (b - a) + kk * u[2]);
    fx[1] = -kappa * gx[0];
    fy[1] = -kappa * gy[0];
    src[2] = kk * c / eps;
    fx[2] = -gx[2];
    fy[2] = -gy[2];
  }
};

}  // namespace pfh
