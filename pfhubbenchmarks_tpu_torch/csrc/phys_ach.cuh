// BM3's Allen-Cahn + heat physics on (U, phi), no anisotropy: the pointwise
// tangent of kernel G (ach_jvp.cu) and of the tile kernels (ach_tile.cu).
// Mirrors benchmarks/bench3.py: terms_tangent.
#pragma once

#include "fem_params.cuh"

namespace pfh {

// constants k[]: D, W0^2, 1/tau0, lambda. With s = 1 - phi^2 and
// g = (phi - lambda U s) s:
//   dg/dU = -lambda s^2,  dg/dphi = 1 - 3 phi^2 + 4 lambda U phi s
//   d src_U   = dU / dt - 1/2 (1/tau0) dg
//   d flux_U  = D grad(dU) + 1/2 (W0^2 / tau0) grad(dphi)
//   d src_phi = dphi / dt - (1/tau0) dg
//   d flux_phi = (W0^2 / tau0) grad(dphi)
struct ACH {
  static constexpr int NF = 2;
  static constexpr int NS = 2;  // the tangent reads U and phi
  __host__ __device__ static constexpr int state_field(int s) { return s; }
  __device__ __forceinline__ static void tangent(
      const JvpParams& P, const float (&u)[NS], const float (&d)[NF],
      const float (&gx)[NF], const float (&gy)[NF], float (&src)[NF],
      float (&fx)[NF], float (&fy)[NF]) {
    const float D = P.k[0], W2 = P.k[1], inv_tau = P.k[2], lam = P.k[3];
    const float U = u[0], phi = u[1];
    const float p2 = phi * phi;
    const float s = 1.0f - p2;
    const float gU = -lam * s * s;
    const float gp = 1.0f - 3.0f * p2 + 4.0f * lam * U * phi * s;
    const float dg = gU * d[0] + gp * d[1];
    const float kw = inv_tau * W2;
    src[0] = d[0] / P.dt - 0.5f * inv_tau * dg;
    fx[0] = D * gx[0] + 0.5f * kw * gx[1];
    fy[0] = D * gy[0] + 0.5f * kw * gy[1];
    src[1] = d[1] / P.dt - inv_tau * dg;
    fx[1] = kw * gx[1];
    fy[1] = kw * gy[1];
  }
};

}  // namespace pfh
