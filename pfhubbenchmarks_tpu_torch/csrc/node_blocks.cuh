// Kernel N, node_blocks: the node-block-Jacobi inverses of one 2D multigrid
// level, f32, in one launch over its vertex and cell-centre grids.
//
// Replaces no TPU kernel: the JAX package builds these blocks with jax.jvp
// in XLA (pfhubbenchmarks_tpu/solve/precond.py:make_block_jacobi, :54), and
// the port built them with torch.func.jvp, 3 x F forward-AD calls and an
// unrolled Gauss-Jordan of a few dozen small torch ops per grid, which held
// the 2D walls (0.78 of bench1's, 0.98 of bench2's on the H100). Per node
//
//   P[i][j] = src_i(e_j) mass + fx_i(e_j) stiff_xx + fy_i(e_j) stiff_yy
//
// with the physics' own pointwise tangent (Phys::tangent, phys_*.cuh, the
// one every J.v kernel runs) in the directions d = e_j (source), gx = e_j
// (flux x) and gy = e_j (flux y) at the node's state, and the node
// diagonals of the mass and stiffness operators (grid.node_diagonals(),
// padded with 1.0). On a Dirichlet vertex (mask != 0 at field i) row i is
// the unit row. Then P^-1 by the no-pivot Gauss-Jordan of
// solve/precond.small_inv in its order of operations (the pivot row divided
// by the pivot, then every other row less its multiple of it), in
// registers: the blocks are diagonally dominant (mass / dt on the
// diagonal), and the getri shape is kept (the Schur recursion is
// unstable). Under a field split the cross-group entries come out of the
// tangent as exact zeros and stay zero through the elimination.
//
// Layout: state planes wv [F, ny+1, nx+1], wm [F, ny, nx] (only the NS
// fields the physics reads, Phys::state_field); diag [3, nvert + ncell]
// (mass, stiff_xx, stiff_yy; vertices, then centres); mask [F, ny+1, nx+1]
// or null; out pv [F, F, ny+1, nx+1] and pm [F, F, ny, nx], the planes
// kernels B, L and the chain kernels read.
//
// The source column comes from Phys::tangent and P and its inverse take
// nvcc's FMA contraction, unless the physics specialises BlockSource (BM1's
// CH, node_blocks_ch.cu): then the source column is evaluated in the order of
// operations in which torch's forward mode differentiates the benchmark's
// terms, and P and the elimination round every product and sum on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), as the torch ops of
// solve/precond.make_block_jacobi and small_inv do on the card. Its planes
// are then those of the torch.func.jvp build to the bit, and bench1's runs
// keep the bits they had before N: with CH::tangent's contracted arithmetic
// bench1's whole run took one Krylov iteration less at its dt = 102.4 step
// and its total solute left the 1e-9 bound it is held to against the JAX
// run's CSV (chip_smoke.py phase 4).
//
// Bound: bytes. Per node it reads NS + 3 (+ F on a masked vertex) floats
// and writes F^2; at bench2's 100^2 (20,201 nodes, 36 outputs each) about
// 3.6 MB, ~1.1 us at 3.35 TB/s, so a launch sits near the launch floor. One
// thread per node keeps the F x 2F augmented block in registers (72 floats
// at F = 6, every index a constant after unrolling); neighbouring threads
// read and write neighbouring addresses of each plane.
#pragma once

#include "fem_params.cuh"

namespace pfh {

// How N takes the source column of P, d src_i / d u_j at the node. By
// default (kExact false) from Phys::tangent in the direction e_j, with P and
// the elimination contracted to FMA. A specialisation with kExact true
// supplies ``column(P, u, j, src)`` and rounds P and the elimination
// operation by operation.
template <class Phys>
struct BlockSource {
  static constexpr bool kExact = false;
};

template <class Phys>
__global__ void __launch_bounds__(kThreads)
node_blocks_kernel(const JvpParams P, const float* __restrict__ wv,
                   const float* __restrict__ wm, const float* __restrict__ diag,
                   const float* __restrict__ mask, float* __restrict__ pv,
                   float* __restrict__ pm, long nvert, long ncell) {
  constexpr int F = Phys::NF;
  constexpr int NS = Phys::NS;
  constexpr bool X = BlockSource<Phys>::kExact;
  const long N = nvert + ncell;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= N) return;
  const bool on_v = idx < nvert;
  const long node = on_v ? idx : idx - nvert;
  const long n = on_v ? nvert : ncell;
  const float* w = on_v ? wv : wm;
  float* out = on_v ? pv : pm;

  float u[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) u[s] = __ldg(w + Phys::state_field(s) * n + node);
  const float mass = __ldg(diag + idx);
  const float sxx = __ldg(diag + N + idx);
  const float syy = __ldg(diag + 2 * N + idx);

  // the augmented block [P | I], row by row
  float a[F][2 * F];
#pragma unroll
  for (int j = 0; j < F; ++j) {
    float e[F], z[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      e[k] = k == j ? 1.0f : 0.0f;
      z[k] = 0.0f;
    }
    float src[F], fx[F], fy[F], s_[F], x_[F], y_[F];
    if constexpr (X)                            // the source column
      BlockSource<Phys>::column(P, u, j, src);
    else
      Phys::tangent(P, u, e, z, z, src, x_, y_);
    Phys::tangent(P, u, z, e, z, s_, fx, y_);   // flux x in gx = e_j
    Phys::tangent(P, u, z, z, e, s_, x_, fy);   // flux y in gy = e_j
#pragma unroll
    for (int i = 0; i < F; ++i) {
      if constexpr (X)
        a[i][j] = __fadd_rn(__fadd_rn(__fmul_rn(src[i], mass),
                                      __fmul_rn(fx[i], sxx)),
                            __fmul_rn(fy[i], syy));
      else
        a[i][j] = src[i] * mass + fx[i] * sxx + fy[i] * syy;
      a[i][F + j] = i == j ? 1.0f : 0.0f;
    }
  }
  if (on_v && mask != nullptr) {
#pragma unroll
    for (int i = 0; i < F; ++i)
      if (__ldg(mask + i * nvert + node) != 0.0f) {
#pragma unroll
        for (int j = 0; j < F; ++j) a[i][j] = i == j ? 1.0f : 0.0f;
      }
  }

  // small_inv: for each pivot i, row i / a[i][i], then row r -= a[r][i] row i
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const float p = a[i][i];
#pragma unroll
    for (int c = 0; c < 2 * F; ++c) a[i][c] = a[i][c] / p;
#pragma unroll
    for (int r = 0; r < F; ++r) {
      if (r == i) continue;
      const float f = a[r][i];
#pragma unroll
      for (int c = 0; c < 2 * F; ++c) {
        if constexpr (X)
          a[r][c] = __fsub_rn(a[r][c], __fmul_rn(f, a[i][c]));
        else
          a[r][c] = a[r][c] - f * a[i][c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < F; ++i)
#pragma unroll
    for (int j = 0; j < F; ++j) out[(i * F + j) * n + node] = a[i][F + j];
}

// Host side: one launch over both grids of the level. params: the
// JvpParams floats (load_params; only the constants and dt are read).
template <class Phys>
int node_blocks(const float* params, const float* wv, const float* wm,
                const float* diag, const float* mask, float* pv, float* pm,
                long nvert, long ncell, void* stream) {
  if (nvert <= 0 || ncell < 0) return static_cast<int>(cudaErrorInvalidValue);
  const JvpParams P = load_params(params);
  node_blocks_kernel<Phys>
      <<<blocks_for(nvert + ncell), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(P, wv, wm, diag, mask, pv, pm,
                                              nvert, ncell);
  return static_cast<int>(cudaGetLastError());
}

// Registers, spills and CTAs per SM of the instantiation (common.cuh).
template <class Phys>
int node_blocks_info(int* out) {
  return kernel_info(node_blocks_kernel<Phys>, kThreads, 0, out);
}

}  // namespace pfh
