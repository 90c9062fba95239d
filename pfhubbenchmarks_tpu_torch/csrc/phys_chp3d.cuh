// BM6's Cahn-Hilliard + Poisson physics on (c, mu, phi) in 3D (bench6_3d),
// the pointwise tangent of the Kuhn-tet box (fem_tet_tile.cuh): kernel U at
// BM6's physics (chp3d_tile.cu) and kernel L's 3D form (lmr_loop_chp3d.cu).
// phys_chp.cuh's tangent on Jvp3Params, its fluxes per axis as phys_ch3d.cuh
// writes them; the mirror of benchmarks/bench6.py: terms_tangent, which
// bench6_3d reuses.
#pragma once

#include "fem_jvp3d.cuh"

// Kernel U's launch bound at 8 points: the CTAs per SM the compiler must fit
// its registers to. The slot sums are 24 floats (CH3: 16); the 60,816 shared
// bytes of a box leave room for three CTAs, but one (226 registers, no
// spills) measured fastest (fem_tet_tile.cuh); the probe
// (tools/torch_tile_probe.py bound) rebuilds the source with another value
// (-DPFH_CHP3D_MIN_CTAS=n).
#ifndef PFH_CHP3D_MIN_CTAS
#define PFH_CHP3D_MIN_CTAS 1
#endif

namespace pfh {

// constants k[]: M, kappa, rho, c_alpha, c_beta, k, epsilon
//   d src_c   = dc / dt                      d flux_c   = M grad(dmu)
//   d src_mu  = dmu - f''(c) dc - k dphi     d flux_mu  = -kappa grad(dc)
//   d src_phi = k dc / epsilon               d flux_phi = -grad(dphi)
// with f_chem = rho (c - c_a)^2 (c_b - c)^2.
struct CHP3 {
  static constexpr int NF = 3;
  static constexpr int NS = 1;  // the tangent reads c only
  // kernel U's CTAs per SM at 8 points (fem_tet_tile.cuh)
  static constexpr int kTetMinCtas8 = PFH_CHP3D_MIN_CTAS;
  __host__ __device__ static constexpr int state_field(int) { return 0; }
  __device__ __forceinline__ static void tangent(
      const Jvp3Params& P, const float (&u)[NS], const float (&d)[NF],
      const float (&g)[NF][3], float (&src)[NF], float (&flux)[NF][3]) {
    const float M = P.k[0], kappa = P.k[1], rho = P.k[2];
    const float kk = P.k[5], eps = P.k[6];
    const float c = u[0];
    const float a = c - P.k[3];
    const float b = P.k[4] - c;
    const float fpp = 2.0f * rho * ((b - a) * (b - a) - 2.0f * a * b);
    src[0] = d[0] / P.dt;
    src[1] = d[1] - fpp * d[0] - kk * d[2];
    src[2] = kk * d[0] / eps;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      flux[0][i] = M * g[1][i];
      flux[1][i] = -kappa * g[0][i];
      flux[2][i] = -g[2][i];
    }
  }
};

}  // namespace pfh
