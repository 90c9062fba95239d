// BM2's Cahn-Hilliard + NE Allen-Cahn physics on (c, mu, eta_1..eta_NE), NE
// in {1, 2, 4}, for every kernel family: the pointwise tangents of kernel F
// (chac_jvp.cu) and of the tile kernels (chac_tile.cu), and the pointwise
// residual terms (kernel R, chac_residual.cu). Mirrors benchmarks/bench2.py:
// make_terms_tangent (coupled and split) and make_terms.
#pragma once

#include "fem_params.cuh"

namespace pfh {

// quintic interpolant h(e) = e^3 (6e^2 - 15e + 10), with h' and h'' as
// written in models/forms.py
__device__ __forceinline__ float h5(float e) {
  return e * e * e * (6.0f * e * e - 15.0f * e + 10.0f);
}
__device__ __forceinline__ float dh(float e) {
  return 3.0f * e * e * (6.0f * e * e - 15.0f * e + 10.0f)
         + e * e * e * (12.0f * e - 15.0f);
}
__device__ __forceinline__ float d2h(float e) {
  return 6.0f * e * (6.0f * e * e - 15.0f * e + 10.0f)
         + 6.0f * e * e * (12.0f * e - 15.0f) + 12.0f * e * e * e;
}

// constants k[]: rho^2, c_alpha, c_beta, kappa_c, kappa_eta, M, w, alpha, L.
// With f_a = rho^2 (c - c_a)^2, f_b = rho^2 (c - c_b)^2, H = sum_i h(e_i),
// dwell(e) = 2 e (1 - e)(1 - 2e) and dwell'(e) = 2 - 12 e + 12 e^2:
//   src_c    = (c - c0) / dt                   flux_c    = M grad(mu)
//   src_mu   = mu - 2 rho^2 ((c - c_a)(1 - H) + (c - c_b) H)
//                                              flux_mu   = -kappa_c grad(c)
//   src_eta_i = (e_i - e0_i) / dt + L [(f_b - f_a) h'(e_i)
//               + w (dwell(e_i) + 2 alpha e_i sum_{j!=i} e_j^2)]
//                                              flux_eta_i = L kappa_eta grad(e_i)
// and the tangent
//   d src_c    = dc / dt                       d flux_c    = M grad(dmu)
//   d src_mu   = dmu - 2 rho^2 (dc + (c_a - c_b) sum_i h'(e_i) de_i)
//                                              d flux_mu   = -kappa_c grad(dc)
//   d src_eta_i = de_i / dt + L [2 rho^2 (c_a - c_b) h'(e_i) dc
//                 + (f_b - f_a) h''(e_i) de_i + w (dwell'(e_i) de_i
//                 + 2 alpha (sum_{j!=i} e_j^2 de_i + 2 e_i sum_{j!=i} e_j de_j))]
//                                              d flux_eta_i = L kappa_eta grad(de_i)
// Split (SPLIT, the tangent of terms_precond): the dc terms of the eta rows,
// the de_j (j != i) terms and the eta terms of the mu row drop out. The
// residual is the same function for both: terms_precond has the values of
// terms.
template <int NE, bool SPLIT>
struct CHAC {
  static constexpr int NF = 2 + NE;
  static constexpr int NS = 1 + NE;  // c and every eta
  __host__ __device__ static constexpr int state_field(int s) {
    return s == 0 ? 0 : s + 1;
  }
  __device__ __forceinline__ static void tangent(
      const JvpParams& P, const float (&u)[NS], const float (&d)[NF],
      const float (&gx)[NF], const float (&gy)[NF], float (&src)[NF],
      float (&fx)[NF], float (&fy)[NF]) {
    const float rho2 = P.k[0], ca = P.k[1], cb = P.k[2];
    const float kc = P.k[3], ke = P.k[4], M = P.k[5];
    const float w = P.k[6], alpha = P.k[7], L = P.k[8];
    const float c = u[0];
    src[0] = d[0] / P.dt;
    fx[0] = M * gx[1];
    fy[0] = M * gy[1];
    fx[1] = -kc * gx[0];
    fy[1] = -kc * gy[0];
    const float fba = rho2 * (c - cb) * (c - cb) - rho2 * (c - ca) * (c - ca);
    float hd = 0.f;  // sum_i h'(e_i) de_i
#pragma unroll
    for (int i = 0; i < NE; ++i) hd += dh(u[1 + i]) * d[2 + i];
    src[1] = SPLIT ? d[1] - 2.0f * rho2 * d[0]
                   : d[1] - 2.0f * rho2 * (d[0] + (ca - cb) * hd);
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const float e = u[1 + i], de = d[2 + i];
      float osq = 0.f, oed = 0.f;  // sum_{j != i} e_j^2 and e_j de_j
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        if (j == i) continue;
        osq += u[1 + j] * u[1 + j];
        oed += u[1 + j] * d[2 + j];
      }
      const float dwp = 2.0f - 12.0f * e + 12.0f * e * e;
      const float diag = fba * d2h(e) + w * (dwp + 2.0f * alpha * osq);
      const float rhs = SPLIT ? diag * de
                              : 2.0f * rho2 * (ca - cb) * dh(e) * d[0] + diag * de
                                    + 4.0f * w * alpha * e * oed;
      src[2 + i] = de / P.dt + L * rhs;
      fx[2 + i] = L * ke * gx[2 + i];
      fy[2 + i] = L * ke * gy[2 + i];
    }
  }
  // u, gx, gy: every field at the point; u0: the previous time level
  __device__ __forceinline__ static void residual(
      const JvpParams& P, const float (&u)[NF], const float (&gx)[NF],
      const float (&gy)[NF], const float (&u0)[NF], float (&src)[NF],
      float (&fx)[NF], float (&fy)[NF]) {
    const float rho2 = P.k[0], ca = P.k[1], cb = P.k[2];
    const float kc = P.k[3], ke = P.k[4], M = P.k[5];
    const float w = P.k[6], alpha = P.k[7], L = P.k[8];
    const float c = u[0];
    float H = 0.f;
#pragma unroll
    for (int i = 0; i < NE; ++i) H += h5(u[2 + i]);
    src[0] = (c - u0[0]) / P.dt;
    fx[0] = M * gx[1];
    fy[0] = M * gy[1];
    src[1] = u[1] - 2.0f * rho2 * ((c - ca) * (1.0f - H) + (c - cb) * H);
    fx[1] = -kc * gx[0];
    fy[1] = -kc * gy[0];
    const float fba = rho2 * (c - cb) * (c - cb) - rho2 * (c - ca) * (c - ca);
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const float e = u[2 + i];
      float osq = 0.f;  // sum_{j != i} e_j^2
#pragma unroll
      for (int j = 0; j < NE; ++j)
        if (j != i) osq += u[2 + j] * u[2 + j];
      const float dwell = 2.0f * e * (1.0f - e) * (1.0f - 2.0f * e);
      const float dfde = fba * dh(e) + w * (dwell + 2.0f * alpha * e * osq);
      src[2 + i] = (e - u0[2 + i]) / P.dt + L * dfde;
      fx[2 + i] = L * ke * gx[2 + i];
      fy[2 + i] = L * ke * gy[2 + i];
    }
  }
};

}  // namespace pfh
