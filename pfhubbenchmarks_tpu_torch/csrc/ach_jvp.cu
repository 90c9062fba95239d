// Kernel G, ach_jvp: J.v of BM3's Allen-Cahn + heat weak form (dendritic
// solidification without anisotropy) on the crossed-P1 grid,
// (w, dt, v) -> (Jv_v, Jv_m), f32; fields (U, phi).
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp at
// BM3's physics (the outer Krylov J.v and the exported A z on the 350^2
// ffc3 grid) and the in-kernel A.z of ops/pallas_vcycle.py:
// make_fused_descend and make_fused_ascend (the dunavant2 levels). The
// gather body is fem_jvp.cuh's; this file supplies the pointwise tangent,
// mirrored by benchmarks/bench3.py:terms_tangent. Unlike kernels A and E
// the tangent reads two state planes (U and phi).
//
// What bounds it on the H100: at BM3's 350^2 one launch reads ~3.9 MB (2
// state and 2 tangent planes of 245,701 nodes; 5.9 MB with b) and writes
// 2.0 MB, and the 4-point rule makes it the heaviest J.v of the port in
// operations per node; ~1,900 blocks of 128 threads fill the card's 132
// SMs over several waves, the first J.v of the port that is not one
// partial wave.

#include "fem_jvp.cuh"

namespace {

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
      const pfh::JvpParams& P, const float (&u)[NS], const float (&d)[NF],
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

}  // namespace

PFH_EXPORT int pfh_ach_jvp(const float* params, int nq, const float* wv,
                           const float* wm, const float* tv, const float* tm,
                           const float* bv, const float* bm, const float* mask,
                           float* ov, float* om, int ny, int nx, void* stream) {
  return pfh::launch_fem_jvp<ACH>(params, nq, wv, wm, tv, tm, bv, bm, mask, ov,
                                  om, ny, nx, stream);
}
