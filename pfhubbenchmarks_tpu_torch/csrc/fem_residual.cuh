// Kernel R: the f32 residual of a crossed-P1 weak form, templated on the
// physics, in the gather shape of fem_jvp.cuh.
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_residual
// (the whole-array f32 residual: _scalar_assembly over the pointwise terms,
// no jvp). Computes
//     out = R(w, w0, dt)
// in f32, where R is sum over cells, triangles and quadrature points of
// weight * (src(u) * test + flux(u, grad u) . grad test), with
// Phys::residual the hand-written mirror of the benchmark's terms. On a
// Dirichlet row (mask != 0) the row is u - g, as DirichletBC.apply_residual
// makes it: mask and g are [F, ny+1, nx+1] planes (g is 0 off the rows).
//
// Layout (fem_params.cuh): unpadded v and m planes. Unlike the J.v, the
// residual reads every field of w and of the previous time level w0.
//
// Design: one thread per output node, as in fem_jvp.cuh. A vertex node sums
// the two triangles it belongs to in each of its (up to) four cells, a
// centre node its cell's four triangles; each node recomputes the terms at
// the quadrature points of the triangles it touches, so there are no
// atomics and every output is summed in one fixed order.
//
// What bounds it on the H100: at the benchmarks' 100^2 one launch reads
// 2F planes of 20,201 nodes (0.3-1.0 MB) and writes F: L2-resident and
// latency-bound, one wave of ~160 blocks, like the gather J.v.
#pragma once

#include "fem_params.cuh"

namespace pfh {

// Residual contribution of cell (y, x) to its slot S, every field.
template <class Phys, int NQ, int S>
__device__ __forceinline__ void cell_residual(const JvpParams& P,
                                              const float* __restrict__ wv,
                                              const float* __restrict__ wm,
                                              const float* __restrict__ w0v,
                                              const float* __restrict__ w0m,
                                              int y, int x, int ny, int nx,
                                              float (&acc)[Phys::NF]) {
  constexpr int NF = Phys::NF;
  const long nvert = static_cast<long>(ny + 1) * (nx + 1);
  const long ncell = static_cast<long>(ny) * nx;
  float wc[NF][5], w0c[NF][5];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    load_slots(wv + f * nvert, wm + f * ncell, y, x, nx, wc[f]);
    load_slots(w0v + f * nvert, w0m + f * ncell, y, x, nx, w0c[f]);
  }
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
        gx[f] += P.Gs[t][s][0] * wc[f][s];
        gy[f] += P.Gs[t][s][1] * wc[f][s];
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float u[NF], u0[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) u[f] = u0[f] = 0.f;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          u[f] += P.Bq[t][q][s] * wc[f][s];
          u0[f] += P.Bq[t][q][s] * w0c[f][s];
        }
      }
      float src[NF], fx[NF], fy[NF];
      Phys::residual(P, u, gx, gy, u0, src, fx, fy);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        acc[f] += P.WB[t][q][S] * src[f] + P.WGx[t][q][S] * fx[f]
                  + P.WGy[t][q][S] * fy[f];
    }
  }
}

template <class Phys, int NQ>
__global__ void __launch_bounds__(kThreads)
fem_residual_kernel(const JvpParams P, const float* __restrict__ wv,
                    const float* __restrict__ wm, const float* __restrict__ w0v,
                    const float* __restrict__ w0m, const float* __restrict__ mask,
                    const float* __restrict__ gv, float* __restrict__ ov,
                    float* __restrict__ om, int ny, int nx) {
  constexpr int NF = Phys::NF;
  const int nvx = nx + 1;
  const long nvert = static_cast<long>(ny + 1) * nvx;
  const long ncell = static_cast<long>(ny) * nx;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvert + ncell) return;
  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.f;
  if (idx < nvert) {
    const int iy = static_cast<int>(idx / nvx);
    const int ix = static_cast<int>(idx % nvx);
    // the node is slot SW of cell (iy, ix), SE of (iy, ix-1),
    // NE of (iy-1, ix-1) and NW of (iy-1, ix)
    if (iy < ny && ix < nx)
      cell_residual<Phys, NQ, 0>(P, wv, wm, w0v, w0m, iy, ix, ny, nx, acc);
    if (iy < ny && ix > 0)
      cell_residual<Phys, NQ, 1>(P, wv, wm, w0v, w0m, iy, ix - 1, ny, nx, acc);
    if (iy > 0 && ix > 0)
      cell_residual<Phys, NQ, 2>(P, wv, wm, w0v, w0m, iy - 1, ix - 1, ny, nx, acc);
    if (iy > 0 && ix < nx)
      cell_residual<Phys, NQ, 3>(P, wv, wm, w0v, w0m, iy - 1, ix, ny, nx, acc);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const long o = f * nvert + idx;
      ov[o] = (mask != nullptr && __ldg(mask + o) != 0.f)
                  ? __ldg(wv + o) - __ldg(gv + o) : acc[f];
    }
  } else {
    const long c = idx - nvert;
    const int iy = static_cast<int>(c / nx);
    const int ix = static_cast<int>(c % nx);
    cell_residual<Phys, NQ, 4>(P, wv, wm, w0v, w0m, iy, ix, ny, nx, acc);
#pragma unroll
    for (int f = 0; f < NF; ++f) om[f * ncell + c] = acc[f];
  }
}

// Host launcher. params: the JvpParams block (fem_params.cuh: load_params);
// mask and gv are both null (no Dirichlet rows) or both given. Built for
// the true-rule residual of the benchmarks only: ffc3, 4 points.
template <class Phys>
int launch_fem_residual(const float* params, int nq, const float* wv,
                        const float* wm, const float* w0v, const float* w0m,
                        const float* mask, const float* gv, float* ov,
                        float* om, int ny, int nx, void* stream) {
  if (nq != 4 || (mask == nullptr) != (gv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const JvpParams P = load_params(params);
  const long n = static_cast<long>(ny + 1) * (nx + 1) + static_cast<long>(ny) * nx;
  fem_residual_kernel<Phys, 4><<<blocks_for(n), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      P, wv, wm, w0v, w0m, mask, gv, ov, om, ny, nx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pfh
