// BM1's mixed Cahn-Hilliard physics on (c, mu) in 3D, the pointwise tangent of
// the Kuhn-tet gather body (fem_jvp3d.cuh): kernel I (ch3d_jvp.cu) and kernel
// L's 3D form (lmr_loop_ch3d.cu). The mirror of benchmarks/bench1.py:
// terms_tangent, which bench1_3d reuses: its fluxes are written per axis.
#pragma once

#include "fem_jvp3d.cuh"

namespace pfh {

// constants k[]: M, kappa, rho_s, c_alpha, c_beta
//   d src_c  = dc / dt             d flux_c  = M grad(dmu)
//   d src_mu = dmu - f''(c) dc     d flux_mu = -kappa grad(dc)
// with f'(c) = 2 rho_s (c - c_a)(c_b - c)((c_b - c) - (c - c_a)).
struct CH3 {
  static constexpr int NF = 2;
  static constexpr int NS = 1;  // the tangent reads c only
  // kernel U's CTAs per SM at 8 points (fem_tet_tile.cuh)
  static constexpr int kTetMinCtas8 = 3;
  __host__ __device__ static constexpr int state_field(int) { return 0; }
  __device__ __forceinline__ static void tangent(
      const Jvp3Params& P, const float (&u)[NS], const float (&d)[NF],
      const float (&g)[NF][3], float (&src)[NF], float (&flux)[NF][3]) {
    const float M = P.k[0], kappa = P.k[1], rho_s = P.k[2];
    const float c = u[0];
    const float a = c - P.k[3];
    const float b = P.k[4] - c;
    const float fpp = 2.0f * rho_s * ((b - a) * (b - a) - 2.0f * a * b);
    src[0] = d[0] / P.dt;
    src[1] = d[1] - fpp * d[0];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      flux[0][i] = M * g[1][i];
      flux[1][i] = -kappa * g[0][i];
    }
  }
};

}  // namespace pfh
