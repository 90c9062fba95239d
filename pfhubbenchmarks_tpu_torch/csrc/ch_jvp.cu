// Kernel A, ch_jvp: J.v of BM1's mixed Cahn-Hilliard weak form on the
// crossed-P1 grid, (w, dt, v) -> (Jv_v, Jv_m), f32.
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp (the
// outer Krylov matvec) and the in-kernel A.z of
// pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_vcycle (per-level
// smoothing and residual J.v, and the exported true-rule pair). The Pallas
// kernels take jax.jvp of the element loop in-kernel; CUDA has no in-kernel
// AD, so the pointwise tangent is written by hand (ch_tangent below, the
// mirror of benchmarks/bench1.py:terms_tangent). The tangent does not
// depend on the previous time level, so w0 is not an argument.
//
// Layout: v planes [2, ny+1, nx+1] (vertices), m planes [2, ny, nx] (cell
// centres), fields (c, mu), unpadded storage.
//
// Design: gather form, one thread per output node. A vertex node sums the
// two triangles it belongs to in each of its (up to) four cells; a centre
// node sums its cell's four triangles. Each node recomputes the quadrature
// point tangents of the triangles it touches, so there is no scatter, no
// atomics and every output is summed in one fixed order.
//
// What bounds it on the H100: at BM1's 100^2 one launch reads ~0.5 MB and
// does ~20 MFLOP, all of it L2-resident (the whole hierarchy is a few MB of
// the 50 MB L2), so a launch is latency-bound (launch + one wave of ~160
// blocks). The design keeps it to ONE launch per J.v, with the tabulation
// and the physics constants passed by value in the parameter space, and the
// quadrature rule (nq = 4 for ffc3, 3 for dunavant2) a template parameter
// so every table index is a compile-time constant.

#include "common.cuh"

namespace {

constexpr int kMaxQ = 4;
constexpr int kParamFloats = 4 * kMaxQ * 5 + 4 * 5 * 2 + 3 * 4 * kMaxQ * 5 + 6;

struct CHParams {
  float Bq[4][kMaxQ][5];   // basis values at quadrature points
  float Gs[4][5][2];       // physical basis gradients per triangle
  float WB[4][kMaxQ][5];   // weight * basis
  float WGx[4][kMaxQ][5];  // weight * d/dx basis
  float WGy[4][kMaxQ][5];  // weight * d/dy basis
  float M, kappa, rho_s, c_alpha, c_beta, dt;
};

// slots of each triangle as a bit mask (S, E, N, W; centre slot 4 in all)
__host__ __device__ constexpr bool slot_in_tri(int t, int s) {
  return (((t == 0) ? 0b10011u : (t == 1) ? 0b10110u
           : (t == 2) ? 0b11100u : 0b11001u) >> s) & 1u;
}

struct CHTangent {
  float src_c, flux_c_x, flux_c_y, src_mu, flux_mu_x, flux_mu_y;
};

// Pointwise tangent of BM1's terms (benchmarks/bench1.py:terms_tangent):
//   d src_c  = dc / dt             d flux_c  = M grad(dmu)
//   d src_mu = dmu - f''(c) dc     d flux_mu = -kappa grad(dc)
// with f'(c) = 2 rho_s (c - c_a)(c_b - c)((c_b - c) - (c - c_a)).
__device__ __forceinline__ CHTangent ch_tangent(const CHParams& P, float c,
                                                float dc, float dmu,
                                                float gdc_x, float gdc_y,
                                                float gdmu_x, float gdmu_y) {
  const float a = c - P.c_alpha;
  const float b = P.c_beta - c;
  const float fpp = 2.0f * P.rho_s * ((b - a) * (b - a) - 2.0f * a * b);
  CHTangent T;
  T.src_c = dc / P.dt;
  T.flux_c_x = P.M * gdmu_x;
  T.flux_c_y = P.M * gdmu_y;
  T.src_mu = dmu - fpp * dc;
  T.flux_mu_x = -P.kappa * gdc_x;
  T.flux_mu_y = -P.kappa * gdc_y;
  return T;
}

// The 5 slot values (SW, SE, NE, NW, C) of field plane (pv, pm) in cell (y, x).
__device__ __forceinline__ void load_slots(const float* __restrict__ pv,
                                           const float* __restrict__ pm,
                                           int y, int x, int nx, float out[5]) {
  const int nvx = nx + 1;
  out[0] = __ldg(pv + y * nvx + x);
  out[1] = __ldg(pv + y * nvx + x + 1);
  out[2] = __ldg(pv + (y + 1) * nvx + x + 1);
  out[3] = __ldg(pv + (y + 1) * nvx + x);
  out[4] = __ldg(pm + y * nx + x);
}

// Contribution of cell (y, x) to its slot S, both fields.
template <int NQ, int S>
__device__ __forceinline__ void cell_contrib(const CHParams& P,
                                             const float* __restrict__ wv,
                                             const float* __restrict__ wm,
                                             const float* __restrict__ tv,
                                             const float* __restrict__ tm,
                                             int y, int x, int ny, int nx,
                                             float& acc_c, float& acc_mu) {
  const long nvert = static_cast<long>(ny + 1) * (nx + 1);
  const long ncell = static_cast<long>(ny) * nx;
  float wc[5], dc[5], dmu[5];
  load_slots(wv, wm, y, x, nx, wc);                  // c at the state
  load_slots(tv, tm, y, x, nx, dc);                  // tangent of c
  load_slots(tv + nvert, tm + ncell, y, x, nx, dmu); // tangent of mu
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!slot_in_tri(t, S)) continue;
    float gdc_x = 0.f, gdc_y = 0.f, gdmu_x = 0.f, gdmu_y = 0.f;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      gdc_x += P.Gs[t][k][0] * dc[k];
      gdc_y += P.Gs[t][k][1] * dc[k];
      gdmu_x += P.Gs[t][k][0] * dmu[k];
      gdmu_y += P.Gs[t][k][1] * dmu[k];
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float c = 0.f, dcq = 0.f, dmuq = 0.f;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        c += P.Bq[t][q][k] * wc[k];
        dcq += P.Bq[t][q][k] * dc[k];
        dmuq += P.Bq[t][q][k] * dmu[k];
      }
      const CHTangent T = ch_tangent(P, c, dcq, dmuq, gdc_x, gdc_y, gdmu_x, gdmu_y);
      acc_c += P.WB[t][q][S] * T.src_c + P.WGx[t][q][S] * T.flux_c_x
               + P.WGy[t][q][S] * T.flux_c_y;
      acc_mu += P.WB[t][q][S] * T.src_mu + P.WGx[t][q][S] * T.flux_mu_x
                + P.WGy[t][q][S] * T.flux_mu_y;
    }
  }
}

// out = Jv (bv == nullptr) or out = b - Jv.
template <int NQ>
__global__ void __launch_bounds__(pfh::kThreads)
ch_jvp_kernel(const CHParams P, const float* __restrict__ wv,
              const float* __restrict__ wm, const float* __restrict__ tv,
              const float* __restrict__ tm, const float* __restrict__ bv,
              const float* __restrict__ bm, float* __restrict__ ov,
              float* __restrict__ om, int ny, int nx) {
  const int nvx = nx + 1;
  const long nvert = static_cast<long>(ny + 1) * nvx;
  const long ncell = static_cast<long>(ny) * nx;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvert + ncell) return;
  float acc_c = 0.f, acc_mu = 0.f;
  if (idx < nvert) {
    const int iy = static_cast<int>(idx / nvx);
    const int ix = static_cast<int>(idx % nvx);
    // the node is slot SW of cell (iy, ix), SE of (iy, ix-1),
    // NE of (iy-1, ix-1) and NW of (iy-1, ix)
    if (iy < ny && ix < nx)
      cell_contrib<NQ, 0>(P, wv, wm, tv, tm, iy, ix, ny, nx, acc_c, acc_mu);
    if (iy < ny && ix > 0)
      cell_contrib<NQ, 1>(P, wv, wm, tv, tm, iy, ix - 1, ny, nx, acc_c, acc_mu);
    if (iy > 0 && ix > 0)
      cell_contrib<NQ, 2>(P, wv, wm, tv, tm, iy - 1, ix - 1, ny, nx, acc_c, acc_mu);
    if (iy > 0 && ix < nx)
      cell_contrib<NQ, 3>(P, wv, wm, tv, tm, iy - 1, ix, ny, nx, acc_c, acc_mu);
    if (bv != nullptr) {
      acc_c = __ldg(bv + idx) - acc_c;
      acc_mu = __ldg(bv + nvert + idx) - acc_mu;
    }
    ov[idx] = acc_c;
    ov[nvert + idx] = acc_mu;
  } else {
    const long c = idx - nvert;
    const int iy = static_cast<int>(c / nx);
    const int ix = static_cast<int>(c % nx);
    cell_contrib<NQ, 4>(P, wv, wm, tv, tm, iy, ix, ny, nx, acc_c, acc_mu);
    if (bm != nullptr) {
      acc_c = __ldg(bm + c) - acc_c;
      acc_mu = __ldg(bm + ncell + c) - acc_mu;
    }
    om[c] = acc_c;
    om[ncell + c] = acc_mu;
  }
}

}  // namespace

PFH_EXPORT int pfh_ch_jvp_param_floats() { return kParamFloats; }

// params: host array of kParamFloats floats in the order of CHParams
// (Bq, Gs, WB, WGx, WGy zero-padded to kMaxQ points, then M, kappa, rho_s,
// c_alpha, c_beta, dt). bv/bm may be null.
PFH_EXPORT int pfh_ch_jvp(const float* params, int nq, const float* wv,
                          const float* wm, const float* tv, const float* tm,
                          const float* bv, const float* bm, float* ov,
                          float* om, int ny, int nx, void* stream) {
  CHParams P;
  const float* p = params;
  auto fill = [&p](float (&W)[4][kMaxQ][5]) {
    for (int t = 0; t < 4; ++t)
      for (int q = 0; q < kMaxQ; ++q)
        for (int s = 0; s < 5; ++s) W[t][q][s] = *p++;
  };
  fill(P.Bq);
  for (int t = 0; t < 4; ++t)
    for (int s = 0; s < 5; ++s)
      for (int d = 0; d < 2; ++d) P.Gs[t][s][d] = *p++;
  fill(P.WB);
  fill(P.WGx);
  fill(P.WGy);
  P.M = *p++;
  P.kappa = *p++;
  P.rho_s = *p++;
  P.c_alpha = *p++;
  P.c_beta = *p++;
  P.dt = *p++;
  const long n = static_cast<long>(ny + 1) * (nx + 1) + static_cast<long>(ny) * nx;
  const int blocks = pfh::blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq == 4) {
    ch_jvp_kernel<4><<<blocks, pfh::kThreads, 0, s>>>(P, wv, wm, tv, tm, bv, bm,
                                                      ov, om, ny, nx);
  } else if (nq == 3) {
    ch_jvp_kernel<3><<<blocks, pfh::kThreads, 0, s>>>(P, wv, wm, tv, tm, bv, bm,
                                                      ov, om, ny, nx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
