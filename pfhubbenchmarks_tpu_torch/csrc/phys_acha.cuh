// BM3's Allen-Cahn + heat physics on (U, phi) with the four-fold anisotropy
// of the published benchmark, a(theta) = 1 + eps_m cos(m (theta - theta0)),
// theta = atan2(phi_y, phi_x), and the Kobayashi rotation flux: the
// pointwise tangent of kernel W (acha_box.cu), the gather (acha_jvp.cu),
// kernel L (lmr_loop_acha.cu) and the chains (vcycle_chain_acha.cu).
// Mirrors benchmarks/bench3.py: make_aniso_terms' terms_tangent.
//
// Its tangent reads the state's gradient (kStateGrad): the bodies form the
// gradient of phi in each triangle (P1: one per triangle) and Phys::tri
// makes the triangle's coefficients from it once; Phys::tangent takes them
// at each point.
#pragma once

#include "fem_params.cuh"

namespace pfh {

// constants k[]: D, W0^2, 1/tau0, lambda (ACH's, in ACH's order), eps_m, m,
// cos(m theta0), sin(m theta0). With kappa = W0^2/tau0, R(x, y) = (-y, x),
// beta = a'/a, inv_tau = 1/(tau0 a^2), r^2 = |grad phi|^2, d theta =
// (phi_x dphi_y - phi_y dphi_x)/r^2, s = 1 - phi^2, g = (phi - lambda U s) s:
//   d inv_tau  = -2 inv_tau beta d theta
//   d beta     = (a''/a - beta^2) d theta,  a'' = -eps_m m^2 cos(m (theta - theta0))
//   d src_U    = dU/dt - 1/2 (inv_tau dg + g d inv_tau)
//   d src_phi  = dphi/dt - (inv_tau dg + g d inv_tau)
//   d flux_phi = kappa (grad dphi + beta R grad dphi + d beta R grad phi)
//   d flux_U   = D grad dU + 1/2 d flux_phi
// Where r^2 <= 1e-20 (the bulk, where the JAX package's double where selects
// a = 1 and a' = 0 with zero tangent) the triangle takes a = 1, beta = 0,
// d beta = d inv_tau = 0: the isotropic tangent (phys_ach.cuh's, to
// rounding). cos and sin of m theta come from (phi_x, phi_y)/r as the m-th
// power of cos theta + i sin theta, in f32 without fast math.
struct ACHA {
  static constexpr int NF = 2;
  static constexpr int NS = 2;  // the tangent reads U and phi
  static constexpr bool kStateGrad = true;
  __host__ __device__ static constexpr int state_field(int s) { return s; }

  // A triangle's coefficients: grad phi (the unit direction (1, 0) off
  // the cut), 1/r^2, beta, a''/a - beta^2 and inv_tau.
  struct Tri {
    float phx, phy, rinv2, beta, dbeta, inv_tau;
  };

  __device__ __forceinline__ static Tri tri(const JvpParams& P,
                                            const float (&ugx)[NS],
                                            const float (&ugy)[NS]) {
    const float inv_tau0 = P.k[2], eps = P.k[4];
    const float phx = ugx[1], phy = ugy[1];
    const float r2 = phx * phx + phy * phy;
    Tri t{1.f, 0.f, 1.f, 0.f, 0.f, inv_tau0};
    if (r2 > 1e-20f) {
      const int m = static_cast<int>(P.k[5]);
      const float fm = P.k[5];
      const float r = sqrtf(r2);
      const float c = phx / r, s = phy / r;
      float cm = 1.f, sm = 0.f;  // cos m theta + i sin m theta
      for (int i = 0; i < m; ++i) {
        const float tmp = cm * c - sm * s;
        sm = sm * c + cm * s;
        cm = tmp;
      }
      // cos and sin of m (theta - theta0)
      const float cp = cm * P.k[6] + sm * P.k[7];
      const float sp = sm * P.k[6] - cm * P.k[7];
      const float a = 1.f + eps * cp;
      const float beta = (-eps * fm * sp) / a;
      t.phx = phx;
      t.phy = phy;
      t.rinv2 = 1.f / r2;
      t.beta = beta;
      t.dbeta = (-eps * fm * fm * cp) / a - beta * beta;
      t.inv_tau = inv_tau0 / (a * a);
    }
    return t;
  }

  __device__ __forceinline__ static void tangent(
      const JvpParams& P, const float (&u)[NS], const Tri& t,
      const float (&d)[NF], const float (&gx)[NF], const float (&gy)[NF],
      float (&src)[NF], float (&fx)[NF], float (&fy)[NF]) {
    const float D = P.k[0], kappa = P.k[1] * P.k[2], lam = P.k[3];
    const float U = u[0], phi = u[1];
    const float p2 = phi * phi;
    const float s = 1.0f - p2;
    const float g = (phi - lam * U * s) * s;
    const float gU = -lam * s * s;
    const float gp = 1.0f - 3.0f * p2 + 4.0f * lam * U * phi * s;
    const float dg = gU * d[0] + gp * d[1];
    const float dth = (t.phx * gy[1] - t.phy * gx[1]) * t.rinv2;
    const float d_inv_tau = -2.0f * t.inv_tau * t.beta * dth;
    const float dgi = t.inv_tau * dg + g * d_inv_tau;
    const float db = t.dbeta * dth;
    const float Fx = kappa * (gx[1] - t.beta * gy[1] - db * t.phy);
    const float Fy = kappa * (gy[1] + t.beta * gx[1] + db * t.phx);
    src[0] = d[0] / P.dt - 0.5f * dgi;
    fx[0] = D * gx[0] + 0.5f * Fx;
    fy[0] = D * gy[0] + 0.5f * Fy;
    src[1] = d[1] / P.dt - dgi;
    fx[1] = Fx;
    fy[1] = Fy;
  }
};

}  // namespace pfh
