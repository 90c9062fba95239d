// Kernel S, shard_sweep: the per-shard body of one sweep of the sharded LMR
// smoother, templated on the physics. f32.
//
// Replaces the pallas_call of pfhubbenchmarks_tpu/parallel/halo_smoother.py:
// make_sharded_lmr_sweep (:153, body :114-151). A shard owns by x bx vertices
// and by x bx cells; its operands arrive extended by the halo exchange
// (parallel/halo.extend): vertex slabs [.., by+2, bx+2] (one line on each
// side) and centre slabs [.., by+1, bx+1] (one line below and left). The
// slab is a grid of (by+1) x (bx+1) cells, the owned cells and the -1 halo
// row and column, in the unpadded layout of fem_params.cuh. Per launch:
//
//   z  = P^-1 r                     at the owned nodes,
//   Az = J(w, dt) z                 at the owned nodes, summed over the
//        slab's cells, each cell's contribution times the logical-cell mask
//
// The mask is 1 on a cell inside the logical ny x nx region and 0 on the
// padding; the halo exchange gives an edge shard zeros for its missing
// neighbour's cells, so the fake halo row and column count nothing either
// (halo_smoother.py:139-146). Outputs: the owned windows [F, by, bx] of z
// and Az, vertices and centres. The two dots of the step length and the
// axpys are kernel C's two stages (lmr.cu), with the all-reduce between
// them. The tangents do not read the previous time level, so w0 is not an
// argument.
//
// Design: the gather form of fem_jvp.cuh, one thread per owned output node;
// a vertex sums its four cells (SW, SE, NE, NW, in that order, as the Pallas
// kernel adds them), a centre its own cell. The node recomputes z at every
// slot node of the cells it reads from the F x F planes and r, so no kernel
// B runs first and z never goes through device memory between them; no
// atomics, one fixed sum order. Each cell whose mask is 0 is skipped (its
// contribution is 0).
//
// What bounds it on the H100: per shard the state, r, P^-1 and mask slabs in
// ((F^2 + 2F + 1) planes) and 4F planes out; at BM3's 350^2 on a 2 x 4 mesh
// (176 x 88 owned nodes of each kind per shard) ~1.5 MB per launch, against
// the function's operations (each cell's tangent once): the bytes bound it,
// ~0.47 us. The kernel takes ~22x that: the gather design does more
// operations than the function (every vertex evaluates its 4 cells, so each
// cell 5 times over its nodes, and recomputes 20 slot z values), and a
// launch of one shard's ~240 blocks is one partial wave on 132 SMs.
#pragma once

#include "fem_jvp.cuh"

namespace pfh {

struct ShardOperands {
  const float* pv;    // [F, F, by+2, bx+2] P^-1 vertex planes
  const float* pm;    // [F, F, by+1, bx+1] P^-1 centre planes
  const float* rv;    // [F, by+2, bx+2]
  const float* rm;    // [F, by+1, bx+1]
  const float* wv;    // [F, by+2, bx+2] linearization state
  const float* wm;    // [F, by+1, bx+1]
  const float* mask;  // [by+1, bx+1] logical-cell mask
  float* zv;          // [F, by, bx] outputs: owned windows
  float* zm;
  float* av;
  float* am;
};

// z_i = sum_j P_ij r_j at node `node` of planes of n nodes each.
template <int NF>
__device__ __forceinline__ void bj_node(const float* __restrict__ P,
                                        const float* __restrict__ r, long node,
                                        long n, float (&z)[NF]) {
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NF; ++j)
      acc += __ldg(P + (static_cast<long>(i) * NF + j) * n + node)
             * __ldg(r + j * n + node);
    z[i] = acc;
  }
}

// The z values at the five slot nodes (SW, SE, NE, NW, C) of slab cell
// (y, x); the slab has nyb x nxb cells.
template <int NF>
__device__ __forceinline__ void z_slots(const ShardOperands& A, int y, int x,
                                        int nyb, int nxb, float (&d)[NF][5]) {
  const int nvx = nxb + 1;
  const long nvert = static_cast<long>(nyb + 1) * nvx;
  const long ncell = static_cast<long>(nyb) * nxb;
  const long vn[4] = {static_cast<long>(y) * nvx + x,
                      static_cast<long>(y) * nvx + x + 1,
                      static_cast<long>(y + 1) * nvx + x + 1,
                      static_cast<long>(y + 1) * nvx + x};
  float z[NF];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    bj_node<NF>(A.pv, A.rv, vn[s], nvert, z);
#pragma unroll
    for (int f = 0; f < NF; ++f) d[f][s] = z[f];
  }
  bj_node<NF>(A.pm, A.rm, static_cast<long>(y) * nxb + x, ncell, z);
#pragma unroll
  for (int f = 0; f < NF; ++f) d[f][4] = z[f];
}

// Masked contribution of slab cell (y, x) to its slot S.
template <class Phys, int NQ, int S>
__device__ __forceinline__ void shard_cell(const JvpParams& P,
                                           const ShardOperands& A, int y, int x,
                                           int nyb, int nxb,
                                           float (&acc)[Phys::NF]) {
  constexpr int NF = Phys::NF;
  const float m = __ldg(A.mask + static_cast<long>(y) * nxb + x);
  if (m == 0.f) return;
  float wc[Phys::NS][5], d[NF][5], part[NF];
  load_state_slots<Phys>(A.wv, A.wm, y, x, nyb, nxb, wc);
  z_slots<NF>(A, y, x, nyb, nxb, d);
#pragma unroll
  for (int f = 0; f < NF; ++f) part[f] = 0.f;
  slot_contrib<Phys, NQ, S>(P, wc, d, part);
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] += m * part[f];
}

template <class Phys, int NQ>
__global__ void __launch_bounds__(kThreads)
shard_sweep_kernel(const JvpParams P, const ShardOperands A, int by, int bx) {
  constexpr int NF = Phys::NF;
  const int nyb = by + 1, nxb = bx + 1;  // the slab's cells
  const long nown = static_cast<long>(by) * bx;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 2 * nown) return;
  const bool on_v = idx < nown;
  const long o = on_v ? idx : idx - nown;
  const int sy = static_cast<int>(o / bx) + 1;  // slab coordinates
  const int sx = static_cast<int>(o % bx) + 1;
  float acc[NF], z[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.f;
  if (on_v) {
    // the node is slot SW of cell (sy, sx), SE of (sy, sx-1), NE of
    // (sy-1, sx-1) and NW of (sy-1, sx); all four lie in the slab
    shard_cell<Phys, NQ, 0>(P, A, sy, sx, nyb, nxb, acc);
    shard_cell<Phys, NQ, 1>(P, A, sy, sx - 1, nyb, nxb, acc);
    shard_cell<Phys, NQ, 2>(P, A, sy - 1, sx - 1, nyb, nxb, acc);
    shard_cell<Phys, NQ, 3>(P, A, sy - 1, sx, nyb, nxb, acc);
    const long nvert = static_cast<long>(nyb + 1) * (nxb + 1);
    bj_node<NF>(A.pv, A.rv, static_cast<long>(sy) * (nxb + 1) + sx, nvert, z);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      A.zv[f * nown + o] = z[f];
      A.av[f * nown + o] = acc[f];
    }
  } else {
    shard_cell<Phys, NQ, 4>(P, A, sy, sx, nyb, nxb, acc);
    const long ncell = static_cast<long>(nyb) * nxb;
    bj_node<NF>(A.pm, A.rm, static_cast<long>(sy) * nxb + sx, ncell, z);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      A.zm[f * nown + o] = z[f];
      A.am[f * nown + o] = acc[f];
    }
  }
}

// Host launcher. params: the JvpParams block of the slab grid (fem_params.
// cuh; its tabulation is the global grid's, the spacing being the same).
template <class Phys>
int launch_shard_sweep(const float* params, int nq, const ShardOperands& A,
                       int by, int bx, void* stream) {
  const JvpParams P = load_params(params);
  const int blocks = blocks_for(2L * by * bx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (by < 1 || bx < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 4) {
    shard_sweep_kernel<Phys, 4><<<blocks, kThreads, 0, s>>>(P, A, by, bx);
  } else if (nq == 3) {
    shard_sweep_kernel<Phys, 3><<<blocks, kThreads, 0, s>>>(P, A, by, bx);
  } else if (nq == 1) {
    shard_sweep_kernel<Phys, 1><<<blocks, kThreads, 0, s>>>(P, A, by, bx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pfh
