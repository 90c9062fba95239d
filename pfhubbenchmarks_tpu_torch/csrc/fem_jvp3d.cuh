// The gather-form J.v of a Kuhn-tet P1 weak form in 3D, templated on the
// physics.
//
// The body of kernel I (ch3d_jvp.cu, the 3D BM1 Cahn-Hilliard), the gather
// form that kernel U (fem_tet_tile.cuh) replaced on every path and that stays
// as U's comparison; its parameter block is U's too. Computes
//     out = J(w, dt) v        (b == nullptr), or   out = b - J(w, dt) v
// in f32 on one vertex grid [F, nz+1, ny+1, nx+1] (unpadded storage; no
// cell centres in 3D, fem/grid3d.py). Replaces the element loop of
// pfhubbenchmarks_tpu/ops/pallas3d.py (_scalar_assembly3d under an in-kernel
// jax.jvp): the whole-array J.v make_pallas_jvp3d and the z-slab J.v
// make_tiled_jvp3d, whose slabs and halo planes are a VMEM device the card
// does not need. The Pallas kernels differentiate the element loop; CUDA has
// no in-kernel AD, so each physics supplies its pointwise tangent by hand
// (Phys::tangent, mirrored by the benchmark's terms_tangent in Python).
//
// Design: one thread per vertex node. The node is corner slot
// S = 4 dz + 2 dy + dx of its (up to) 8 incident cells; in each it sums the
// Kuhn tets that contain S (slots 0 and 7 lie in all 6 tets, every other slot
// in 2: up to 24 tets per node), recomputing at each of the rule's points the
// tangent from the tet's 4 vertices. No scatter, no atomics, one fixed
// summation order (cells by slot 0..7, tets 0..5, points in order). A tet
// reads only its own 4 vertices: the exact zeros of the 8-slot tabulation,
// which the Pallas kernel skips at trace time, are never touched.
//
// Parameter block: the rule's barycentric values (the same in every Kuhn tet),
// and per tet and local vertex the weighted basis, the weighted gradients and
// the gradients, the physics constants and dt, passed by value (3,540 bytes
// at the 8-point ffc3 rule, under the 4 KB kernel-parameter limit), so every
// table index is a compile-time constant. The point count is a template
// parameter: 1 (keast1), 4 (keast2) or 8 (ffc3).
#pragma once

#include "common.cuh"

namespace pfh {

constexpr int kMaxQ3 = 8;
constexpr int kMaxConst3 = 12;

struct Jvp3Params {
  float Bq[kMaxQ3][4];        // barycentric basis values at the points
  float WB[6][kMaxQ3][4];     // weight * basis, per tet and local vertex
  float WG[6][kMaxQ3][4][3];  // weight * physical gradient
  float Gs[6][4][3];          // physical basis gradients per tet
  float k[kMaxConst3];        // physics constants, in the physics' own order
  float dt;
};

constexpr int kJvp3ParamFloats = sizeof(Jvp3Params) / sizeof(float);

// Host side: the block from kJvp3ParamFloats floats in the order of
// Jvp3Params (tables zero-padded to kMaxQ3 points, the constants padded to
// kMaxConst3, then dt).
inline Jvp3Params load_params3(const float* params) {
  Jvp3Params P;
  float* dst = reinterpret_cast<float*>(&P);
  for (int i = 0; i < kJvp3ParamFloats; ++i) dst[i] = params[i];
  return P;
}

// Corner slot of local vertex j of Kuhn tet t: _TETS of fem/grid3d.py,
//   {0,1,3,7} {0,1,5,7} {0,4,5,7} {0,2,3,7} {0,4,6,7} {0,2,6,7}.
__host__ __device__ constexpr int tet_vert(int t, int j) {
  return j == 0 ? 0
         : j == 3 ? 7
         : j == 1 ? ((t == 0 || t == 1) ? 1 : (t == 2 || t == 4) ? 4 : 2)
                  : ((t == 0 || t == 3) ? 3 : (t == 1 || t == 2) ? 5 : 6);
}

// Local index of slot s in tet t, or -1 if the tet does not contain it.
__host__ __device__ constexpr int tet_local(int t, int s) {
  return tet_vert(t, 0) == s   ? 0
         : tet_vert(t, 1) == s ? 1
         : tet_vert(t, 2) == s ? 2
         : tet_vert(t, 3) == s ? 3
                               : -1;
}

// Contribution of tet T of one cell to its slot S (when T contains S).
// wc, d: the cell's 8 corner values of the state planes and the tangents.
template <class Phys, int NQ, int S, int T>
__device__ __forceinline__ void tet_contrib(const Jvp3Params& P,
                                            const float (&wc)[Phys::NS][8],
                                            const float (&d)[Phys::NF][8],
                                            float (&acc)[Phys::NF]) {
  constexpr int NF = Phys::NF;
  constexpr int NS = Phys::NS;
  constexpr int K = tet_local(T, S);
  if constexpr (K >= 0) {
    float g[NF][3];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) s += P.Gs[T][j][a] * d[f][tet_vert(T, j)];
        g[f][a] = s;
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float u[NS], dq[NF];
#pragma unroll
      for (int f = 0; f < NS; ++f) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) s += P.Bq[q][j] * wc[f][tet_vert(T, j)];
        u[f] = s;
      }
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) s += P.Bq[q][j] * d[f][tet_vert(T, j)];
        dq[f] = s;
      }
      float src[NF], flux[NF][3];
      Phys::tangent(P, u, dq, g, src, flux);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        acc[f] += P.WB[T][q][K] * src[f] + P.WG[T][q][K][0] * flux[f][0]
                  + P.WG[T][q][K][1] * flux[f][1] + P.WG[T][q][K][2] * flux[f][2];
    }
  }
}

// Contribution of cell (cz, cy, cx) to its slot S, every field.
template <class Phys, int NQ, int S>
__device__ __forceinline__ void cell_contrib3(const Jvp3Params& P,
                                              const float* __restrict__ wv,
                                              const float* __restrict__ tv,
                                              int cz, int cy, int cx, int ny,
                                              int nx, long nvert,
                                              float (&acc)[Phys::NF]) {
  constexpr int NF = Phys::NF;
  constexpr int NS = Phys::NS;
  const long sy = nx + 1;
  const long sz = static_cast<long>(ny + 1) * sy;
  const long base = cz * sz + cy * sy + cx;
  float wc[NS][8], d[NF][8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const long o = base + (s >> 2) * sz + ((s >> 1) & 1) * sy + (s & 1);
#pragma unroll
    for (int f = 0; f < NS; ++f)
      wc[f][s] = __ldg(wv + Phys::state_field(f) * nvert + o);
#pragma unroll
    for (int f = 0; f < NF; ++f) d[f][s] = __ldg(tv + f * nvert + o);
  }
  tet_contrib<Phys, NQ, S, 0>(P, wc, d, acc);
  tet_contrib<Phys, NQ, S, 1>(P, wc, d, acc);
  tet_contrib<Phys, NQ, S, 2>(P, wc, d, acc);
  tet_contrib<Phys, NQ, S, 3>(P, wc, d, acc);
  tet_contrib<Phys, NQ, S, 4>(P, wc, d, acc);
  tet_contrib<Phys, NQ, S, 5>(P, wc, d, acc);
}

// The node is slot S of cell (iz - dz, iy - dy, ix - dx), if that cell exists.
template <class Phys, int NQ, int S>
__device__ __forceinline__ void visit(const Jvp3Params& P,
                                      const float* __restrict__ wv,
                                      const float* __restrict__ tv, int iz,
                                      int iy, int ix, int nz, int ny, int nx,
                                      long nvert, float (&acc)[Phys::NF]) {
  const int cz = iz - (S >> 2), cy = iy - ((S >> 1) & 1), cx = ix - (S & 1);
  if (cz >= 0 && cz < nz && cy >= 0 && cy < ny && cx >= 0 && cx < nx)
    cell_contrib3<Phys, NQ, S>(P, wv, tv, cz, cy, cx, ny, nx, nvert, acc);
}

// The gather sum of J(w) t at vertex idx, every field: the node's (up to) 8
// cells in slot order.
template <class Phys, int NQ>
__device__ __forceinline__ void jvp3_node(const Jvp3Params& P,
                                          const float* __restrict__ wv,
                                          const float* __restrict__ tv, long idx,
                                          int nz, int ny, int nx,
                                          float (&acc)[Phys::NF]) {
  const int nvx = nx + 1, nvy = ny + 1;
  const long nvert = static_cast<long>(nz + 1) * nvy * nvx;
  const int ix = static_cast<int>(idx % nvx);
  const long rest = idx / nvx;
  const int iy = static_cast<int>(rest % nvy);
  const int iz = static_cast<int>(rest / nvy);
#pragma unroll
  for (int f = 0; f < Phys::NF; ++f) acc[f] = 0.f;
  visit<Phys, NQ, 0>(P, wv, tv, iz, iy, ix, nz, ny, nx, nvert, acc);
  visit<Phys, NQ, 1>(P, wv, tv, iz, iy, ix, nz, ny, nx, nvert, acc);
  visit<Phys, NQ, 2>(P, wv, tv, iz, iy, ix, nz, ny, nx, nvert, acc);
  visit<Phys, NQ, 3>(P, wv, tv, iz, iy, ix, nz, ny, nx, nvert, acc);
  visit<Phys, NQ, 4>(P, wv, tv, iz, iy, ix, nz, ny, nx, nvert, acc);
  visit<Phys, NQ, 5>(P, wv, tv, iz, iy, ix, nz, ny, nx, nvert, acc);
  visit<Phys, NQ, 6>(P, wv, tv, iz, iy, ix, nz, ny, nx, nvert, acc);
  visit<Phys, NQ, 7>(P, wv, tv, iz, iy, ix, nz, ny, nx, nvert, acc);
}

template <class Phys, int NQ>
__global__ void __launch_bounds__(kThreads)
fem_jvp3d_kernel(const Jvp3Params P, const float* __restrict__ wv,
                 const float* __restrict__ tv, const float* __restrict__ bv,
                 float* __restrict__ ov, int nz, int ny, int nx) {
  constexpr int NF = Phys::NF;
  const int nvx = nx + 1, nvy = ny + 1;
  const long nvert = static_cast<long>(nz + 1) * nvy * nvx;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvert) return;
  float acc[NF];
  jvp3_node<Phys, NQ>(P, wv, tv, idx, nz, ny, nx, acc);
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const long o = f * nvert + idx;
    ov[o] = (bv != nullptr) ? __ldg(bv + o) - acc[f] : acc[f];
  }
}

// Host launcher. params: kJvp3ParamFloats floats in the order of Jvp3Params
// (tables zero-padded to kMaxQ3 points, the constants padded to kMaxConst3,
// then dt). bv may be null.
template <class Phys>
int launch_fem_jvp3d(const float* params, int nq, const float* wv,
                     const float* tv, const float* bv, float* ov, int nz,
                     int ny, int nx, void* stream) {
  const Jvp3Params P = load_params3(params);
  const long n = static_cast<long>(nz + 1) * (ny + 1) * (nx + 1);
  const int blocks = blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq == 8) {
    fem_jvp3d_kernel<Phys, 8><<<blocks, kThreads, 0, s>>>(P, wv, tv, bv, ov, nz,
                                                          ny, nx);
  } else if (nq == 4) {
    fem_jvp3d_kernel<Phys, 4><<<blocks, kThreads, 0, s>>>(P, wv, tv, bv, ov, nz,
                                                          ny, nx);
  } else if (nq == 1) {
    fem_jvp3d_kernel<Phys, 1><<<blocks, kThreads, 0, s>>>(P, wv, tv, bv, ov, nz,
                                                          ny, nx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pfh
