// The gather-form J.v of a crossed-P1 weak form, templated on the physics.
//
// Shared body of kernel A (ch_jvp.cu, BM1's Cahn-Hilliard), kernel E
// (chp_jvp.cu, BM6's Cahn-Hilliard + Poisson), kernel F (chac_jvp.cu,
// BM2's Cahn-Hilliard + Allen-Cahn) and kernel G (ach_jvp.cu), and, per
// node (jvp_node, jvp_store), of kernel L's A z (lmr_loop.cuh) and the
// ascend chain's residual (vcycle_chain.cuh). Computes
//     out = J(w, dt) v        (b == nullptr), or   out = b - J(w, dt) v
// in f32, with an optional 0/1 vertex mask of Dirichlet rows: on a masked row
// the J.v is v itself (the tangent of a constraint row u - g), so the result
// is v, or b - v in the residual form. That is the in-kernel edge mask
// ``av*keep + z*(1-keep)`` of pfhubbenchmarks_tpu/ops/pallas_vcycle.py.
//
// The Pallas kernels take jax.jvp of the element loop in-kernel; CUDA has no
// in-kernel AD, so each physics supplies its pointwise tangent by hand
// (Phys::tangent, mirrored by the benchmark's terms_tangent in Python). A
// tangent reads Phys::NS state planes, fields Phys::state_field(0..NS-1) of
// w (c alone for CH and CH+Poisson; c and every eta for CH+AC).
//
// Layout (fem_params.cuh): unpadded v and m planes; the mask is
// [F, ny+1, nx+1] floats, nonzero on a Dirichlet row. The physics live in
// phys_*.cuh, shared with the tile (fem_tile.cuh) and residual
// (fem_residual.cuh) kernels.
//
// Design: one thread per output node. A vertex node sums the two triangles
// it belongs to in each of its (up to) four cells; a centre node sums its
// cell's four triangles. Each node recomputes the quadrature-point tangents
// of the triangles it touches, so there is no scatter, no atomics, and every
// output is summed in one fixed order. The tabulation and the constants are
// passed by value in the parameter space and the rule's point count is a
// template parameter (1, 3 or 4 points), so every table index is a
// compile-time constant.
#pragma once

#include "fem_params.cuh"

namespace pfh {

// Contribution of one cell to its slot S, every field, from the cell's slot
// values: wc, the state planes the tangent reads; d, the tangent's fields.
template <class Phys, int NQ, int S>
__device__ __forceinline__ void slot_contrib(const JvpParams& P,
                                             const float (&wc)[Phys::NS][5],
                                             const float (&d)[Phys::NF][5],
                                             float (&acc)[Phys::NF]) {
  constexpr int NF = Phys::NF;
  constexpr int NS = Phys::NS;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!slot_in_tri(t, S)) continue;
    float gx[NF], gy[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) gx[f] = gy[f] = 0.f;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        gx[f] += P.Gs[t][s][0] * d[f][s];
        gy[f] += P.Gs[t][s][1] * d[f][s];
      }
    }
    // the triangle's coefficients from the state's gradient, once
    [[maybe_unused]] typename TriOf<Phys>::type tri;
    if constexpr (kReadsStateGrad<Phys>) {
      float ugx[NS], ugy[NS];
      state_grad<NS>(P, t, wc, ugx, ugy);
      tri = Phys::tri(P, ugx, ugy);
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float u[NS], dq[NF];
#pragma unroll
      for (int f = 0; f < NS; ++f) u[f] = 0.f;
#pragma unroll
      for (int f = 0; f < NF; ++f) dq[f] = 0.f;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
#pragma unroll
        for (int f = 0; f < NS; ++f) u[f] += P.Bq[t][q][s] * wc[f][s];
#pragma unroll
        for (int f = 0; f < NF; ++f) dq[f] += P.Bq[t][q][s] * d[f][s];
      }
      float src[NF], fx[NF], fy[NF];
      if constexpr (kReadsStateGrad<Phys>)
        Phys::tangent(P, u, tri, dq, gx, gy, src, fx, fy);
      else
        Phys::tangent(P, u, dq, gx, gy, src, fx, fy);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        acc[f] += P.WB[t][q][S] * src[f] + P.WGx[t][q][S] * fx[f]
                  + P.WGy[t][q][S] * fy[f];
    }
  }
}

// The state slots the tangent reads in cell (y, x) of planes (wv, wm).
template <class Phys>
__device__ __forceinline__ void load_state_slots(const float* __restrict__ wv,
                                                 const float* __restrict__ wm,
                                                 int y, int x, int ny, int nx,
                                                 float (&wc)[Phys::NS][5]) {
  const long nvert = static_cast<long>(ny + 1) * (nx + 1);
  const long ncell = static_cast<long>(ny) * nx;
#pragma unroll
  for (int s = 0; s < Phys::NS; ++s)
    load_slots(wv + Phys::state_field(s) * nvert,
               wm + Phys::state_field(s) * ncell, y, x, nx, wc[s]);
}

// Contribution of cell (y, x) to its slot S, every field; the tangent
// planes (tv, tm) are read by Ld (fem_params.cuh).
template <class Phys, int NQ, int S, class Ld = LoadRO>
__device__ __forceinline__ void cell_contrib(const JvpParams& P,
                                             const float* __restrict__ wv,
                                             const float* __restrict__ wm,
                                             const float* __restrict__ tv,
                                             const float* __restrict__ tm,
                                             int y, int x, int ny, int nx,
                                             float (&acc)[Phys::NF]) {
  constexpr int NF = Phys::NF;
  const long nvert = static_cast<long>(ny + 1) * (nx + 1);
  const long ncell = static_cast<long>(ny) * nx;
  float wc[Phys::NS][5], d[NF][5];
  load_state_slots<Phys>(wv, wm, y, x, ny, nx, wc);
#pragma unroll
  for (int f = 0; f < NF; ++f)
    load_slots<Ld>(tv + f * nvert, tm + f * ncell, y, x, nx, d[f]);
  slot_contrib<Phys, NQ, S>(P, wc, d, acc);
}

// The gather sum of J(w) t at node idx (vertices first, then centres), every
// field: a vertex sums the two triangles it belongs to in each of its (up
// to) four cells, a centre its cell's four triangles. The body of the J.v
// kernels below and of kernel L's A z (lmr_loop.cuh).
template <class Phys, int NQ, class Ld = LoadRO>
__device__ __forceinline__ void jvp_node(const JvpParams& P,
                                         const float* __restrict__ wv,
                                         const float* __restrict__ wm,
                                         const float* __restrict__ tv,
                                         const float* __restrict__ tm, long idx,
                                         int ny, int nx, float (&acc)[Phys::NF]) {
  const int nvx = nx + 1;
  const long nvert = static_cast<long>(ny + 1) * nvx;
#pragma unroll
  for (int f = 0; f < Phys::NF; ++f) acc[f] = 0.f;
  if (idx < nvert) {
    const int iy = static_cast<int>(idx / nvx);
    const int ix = static_cast<int>(idx % nvx);
    // the node is slot SW of cell (iy, ix), SE of (iy, ix-1),
    // NE of (iy-1, ix-1) and NW of (iy-1, ix)
    if (iy < ny && ix < nx)
      cell_contrib<Phys, NQ, 0, Ld>(P, wv, wm, tv, tm, iy, ix, ny, nx, acc);
    if (iy < ny && ix > 0)
      cell_contrib<Phys, NQ, 1, Ld>(P, wv, wm, tv, tm, iy, ix - 1, ny, nx, acc);
    if (iy > 0 && ix > 0)
      cell_contrib<Phys, NQ, 2, Ld>(P, wv, wm, tv, tm, iy - 1, ix - 1, ny, nx, acc);
    if (iy > 0 && ix < nx)
      cell_contrib<Phys, NQ, 3, Ld>(P, wv, wm, tv, tm, iy - 1, ix, ny, nx, acc);
  } else {
    const long c = idx - nvert;
    cell_contrib<Phys, NQ, 4, Ld>(P, wv, wm, tv, tm, static_cast<int>(c / nx),
                                  static_cast<int>(c % nx), ny, nx, acc);
  }
}

// The J.v's output at node idx from its gather sum acc: on a Dirichlet row
// (mask != 0) the tangent value itself, then b - value where b is given.
// The planes tv and b are read by Ld: the J.v kernels' LoadRO, or LoadCG in
// a launch that wrote them earlier (the ascend chain, vcycle_chain.cuh).
template <int NF, class Ld = LoadRO>
__device__ __forceinline__ void jvp_store(const float (&acc)[NF], long idx,
                                          long nvert, long ncell,
                                          const float* __restrict__ tv,
                                          const float* __restrict__ bv,
                                          const float* __restrict__ bm,
                                          const float* __restrict__ mask,
                                          float* __restrict__ ov,
                                          float* __restrict__ om) {
  if (idx < nvert) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const long o = f * nvert + idx;
      float val = acc[f];
      if (mask != nullptr && __ldg(mask + o) != 0.f) val = Ld::ld(tv + o);
      if (bv != nullptr) val = Ld::ld(bv + o) - val;
      ov[o] = val;
    }
  } else {
    const long c = idx - nvert;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const long o = f * ncell + c;
      om[o] = (bm != nullptr) ? Ld::ld(bm + o) - acc[f] : acc[f];
    }
  }
}

template <class Phys, int NQ>
__global__ void __launch_bounds__(kThreads)
fem_jvp_kernel(const JvpParams P, const float* __restrict__ wv,
               const float* __restrict__ wm, const float* __restrict__ tv,
               const float* __restrict__ tm, const float* __restrict__ bv,
               const float* __restrict__ bm, const float* __restrict__ mask,
               float* __restrict__ ov, float* __restrict__ om, int ny, int nx) {
  constexpr int NF = Phys::NF;
  const int nvx = nx + 1;
  const long nvert = static_cast<long>(ny + 1) * nvx;
  const long ncell = static_cast<long>(ny) * nx;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvert + ncell) return;
  float acc[NF];
  jvp_node<Phys, NQ>(P, wv, wm, tv, tm, idx, ny, nx, acc);
  jvp_store<NF>(acc, idx, nvert, ncell, tv, bv, bm, mask, ov, om);
}

// Host launcher. params: kJvpParamFloats floats in the order of JvpParams
// (Bq, Gs, WB, WGx, WGy zero-padded to kMaxQ points, the constants padded to
// kMaxConst, then dt). bv/bm and mask may be null.
template <class Phys>
int launch_fem_jvp(const float* params, int nq, const float* wv,
                   const float* wm, const float* tv, const float* tm,
                   const float* bv, const float* bm, const float* mask,
                   float* ov, float* om, int ny, int nx, void* stream) {
  const JvpParams P = load_params(params);
  const long n = static_cast<long>(ny + 1) * (nx + 1) + static_cast<long>(ny) * nx;
  const int blocks = blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq == 4) {
    fem_jvp_kernel<Phys, 4><<<blocks, kThreads, 0, s>>>(P, wv, wm, tv, tm, bv, bm,
                                                        mask, ov, om, ny, nx);
  } else if (nq == 3) {
    fem_jvp_kernel<Phys, 3><<<blocks, kThreads, 0, s>>>(P, wv, wm, tv, tm, bv, bm,
                                                        mask, ov, om, ny, nx);
  } else if (nq == 1) {
    fem_jvp_kernel<Phys, 1><<<blocks, kThreads, 0, s>>>(P, wv, wm, tv, tm, bv, bm,
                                                        mask, ov, om, ny, nx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pfh
