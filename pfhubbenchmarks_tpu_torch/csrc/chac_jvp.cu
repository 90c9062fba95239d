// Kernel F, chac_jvp: J.v of BM2's Cahn-Hilliard + NE Allen-Cahn weak form
// on the crossed-P1 grid, (w, dt, v) -> (Jv_v, Jv_m), f32; fields
// (c, mu, eta_1..eta_NE), NE in {1, 2, 4}.
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp at
// BM2's physics (the outer Krylov J.v) and the in-kernel A.z of
// make_fused_vcycle, make_pallas_lmr_sweep_loop, make_pallas_lmr_sweep and
// make_tiled_lmr_sweep. Two operators:
//   - coupled (SPLIT = false): the tangent of benchmarks/bench2.py's terms,
//     for the outer J.v and the exported A z (the ffc3 fine grid);
//   - split (SPLIT = true): the tangent of terms_precond, whose cross-group
//     couplings are stopped, so the Jacobian is diag(J_CH, J_AC1..J_ACNE);
//     for every multigrid level (the dunavant1 rule).
// The gather body is fem_jvp.cuh's; this file supplies the pointwise
// tangents, mirrored by benchmarks/bench2.py's terms_tangent and
// terms_tangent_split.
//
// What bounds it on the H100: at BM2's 100^2 one launch reads ~0.9 MB (the
// 5 state planes and 6 tangent planes of 20,201 nodes each; 1.4 MB with b)
// and writes 0.5 MB, all L2-resident; a launch is one wave of ~160 blocks,
// latency-bound like kernels A and E.

#include "fem_jvp.cuh"

namespace {

// quintic interpolant h(e) = e^3 (6e^2 - 15e + 10): h' and h'' as written in
// models/forms.py
__device__ __forceinline__ float dh(float e) {
  return 3.0f * e * e * (6.0f * e * e - 15.0f * e + 10.0f)
         + e * e * e * (12.0f * e - 15.0f);
}
__device__ __forceinline__ float d2h(float e) {
  return 6.0f * e * (6.0f * e * e - 15.0f * e + 10.0f)
         + 6.0f * e * e * (12.0f * e - 15.0f) + 12.0f * e * e * e;
}

// constants k[]: rho^2, c_alpha, c_beta, kappa_c, kappa_eta, M, w, alpha, L.
// With f_a = rho^2 (c - c_a)^2, f_b = rho^2 (c - c_b)^2 and
// dwell'(e) = 2 - 12 e + 12 e^2:
//   d src_c    = dc / dt                       d flux_c    = M grad(dmu)
//   d src_mu   = dmu - 2 rho^2 (dc + (c_a - c_b) sum_i h'(e_i) de_i)
//                                              d flux_mu   = -kappa_c grad(dc)
//   d src_eta_i = de_i / dt + L [2 rho^2 (c_a - c_b) h'(e_i) dc
//                 + (f_b - f_a) h''(e_i) de_i + w (dwell'(e_i) de_i
//                 + 2 alpha (sum_{j!=i} e_j^2 de_i + 2 e_i sum_{j!=i} e_j de_j))]
//                                              d flux_eta_i = L kappa_eta grad(de_i)
// Split: the dc terms of the eta rows, the de_j (j != i) terms and the eta
// terms of the mu row drop out.
template <int NE, bool SPLIT>
struct CHAC {
  static constexpr int NF = 2 + NE;
  static constexpr int NS = 1 + NE;  // c and every eta
  __host__ __device__ static constexpr int state_field(int s) {
    return s == 0 ? 0 : s + 1;
  }
  __device__ __forceinline__ static void tangent(
      const pfh::JvpParams& P, const float (&u)[NS], const float (&d)[NF],
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
};

template <int NE>
int launch_ne(bool split, const float* params, int nq, const float* wv,
              const float* wm, const float* tv, const float* tm,
              const float* bv, const float* bm, const float* mask, float* ov,
              float* om, int ny, int nx, void* stream) {
  return split ? pfh::launch_fem_jvp<CHAC<NE, true>>(
                     params, nq, wv, wm, tv, tm, bv, bm, mask, ov, om, ny, nx, stream)
               : pfh::launch_fem_jvp<CHAC<NE, false>>(
                     params, nq, wv, wm, tv, tm, bv, bm, mask, ov, om, ny, nx, stream);
}

}  // namespace

// ne: the number of Allen-Cahn fields (1, 2 or 4); split: 0 for the coupled
// operator, 1 for the field-split one.
PFH_EXPORT int pfh_chac_jvp(const float* params, int nq, int ne, int split,
                            const float* wv, const float* wm, const float* tv,
                            const float* tm, const float* bv, const float* bm,
                            const float* mask, float* ov, float* om, int ny,
                            int nx, void* stream) {
  switch (ne) {
    case 1:
      return launch_ne<1>(split != 0, params, nq, wv, wm, tv, tm, bv, bm, mask,
                          ov, om, ny, nx, stream);
    case 2:
      return launch_ne<2>(split != 0, params, nq, wv, wm, tv, tm, bv, bm, mask,
                          ov, om, ny, nx, stream);
    case 4:
      return launch_ne<4>(split != 0, params, nq, wv, wm, tv, tm, bv, bm, mask,
                          ov, om, ny, nx, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
