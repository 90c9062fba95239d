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

// ---- The one-launch build: every level of a hierarchy, with its injections
//
// node_build_kernel is the multigrid build of solve/gmg.py in one launch:
// the planes of node_blocks_kernel at every level of a 2D hierarchy, and
// the injected (w, w0) states of the coarse levels, which the chains,
// kernel V and the dense coarse inverse read. It replaces, per build, one
// launch of node_blocks_kernel per level and the state injections between
// them (kernel D at a dyadic pair, strided slicing at an odd ratio; 7
// wrapper calls at bench1's and bench2's three levels).
//
// Why. node_blocks_kernel's time hardly moves with the level's size (7.9 us
// at 25^2 and at 50^2, 9.3 us at 100^2 on the H100): one thread runs the
// node's 3F tangents and the F x 2F Gauss-Jordan as one serial chain, and a
// small level fills a few CTAs. The levels are independent, and an
// injection is a copy: coarse node k of level l is one node of the finest
// level (the composed index, ops/node_blocks.composed_index: a coarse
// vertex is the fine vertex R times its index; a coarse centre is the fine
// vertex (2y+1, 2x+1) at R = 2 and the fine centre (Ry+o, Rx+o), o =
// (R-1)/2, at an odd R), so every level reads its state from the finest
// level's planes and no level waits for another.
//
// Design. F lanes per node, neighbouring lanes of one warp, 32 / F nodes a
// warp (at F = 3 and 6 the last 2 lanes of a warp pad: they repeat a column
// of the warp's first node and store nothing); lane j owns column j of P and
// column F + j of [P | I].
// Lane j takes the tangents in the directions e_j (source, flux x, flux y),
// as the one-thread kernel does for its column j, and forms P's column j.
// The elimination runs pivot by pivot: the pivot column i reaches every lane
// of the node by F warp shuffles from lane i, then each lane divides its two
// entries of row i by the pivot and subtracts the multiple of row i from
// its entries of every other row. Every entry of P and of P^-1 gets the
// operations of node_blocks_kernel in its order (the exact form's
// __fmul_rn, __fadd_rn, __fsub_rn and IEEE divisions, the others' contracted
// expressions written as there), so the planes are its bits. Lane j also
// copies field j of the node's state and previous state from the finest
// level into the level's injected planes (levels past the first).
//
// The levels' records (int64, kBuildRecord each, a device table fixed once
// per hierarchy by ops/node_blocks.NodeBuildPlan): nvert, ncell, the
// level's first node in the launch's node order, the offsets of its
// diagonals in diag, of its mask in mask (-1: none), of its composed index
// in src (-1: the finest level, which reads itself), of its planes in
// planes (pv [F, F, nvert] then pm [F, F, ncell]) and of its states in
// states (wv [F, nvert], wm [F, ncell], w0v, w0m; -1 at the finest level).
//
// Bound: bytes, as node_blocks_kernel's summed over the levels, plus the
// injected states (read and written once; a coarse level's tangent reads
// are among the injection's, and the composed index, which a ratio gives by
// arithmetic, is not counted). The chain per node is 3
// tangents and F pivots of F shuffles, 2 divisions and 2 (F - 1) products
// per lane, in place of 3F tangents and F pivots of 2F divisions and
// 2F (F - 1) products in one thread.
constexpr int kBuildRecord = 8;

template <class Phys>
__global__ void __launch_bounds__(kThreads)
node_build_kernel(const JvpParams P, const long long* __restrict__ rec,
                  int nlev, long total, const float* __restrict__ wv,
                  const float* __restrict__ wm, const float* __restrict__ w0v,
                  const float* __restrict__ w0m,
                  const float* __restrict__ diag,
                  const float* __restrict__ mask,
                  const int* __restrict__ src, float* __restrict__ planes,
                  float* __restrict__ states) {
  constexpr int F = Phys::NF;
  constexpr int NS = Phys::NS;
  constexpr int NPW = 32 / F;   // nodes a warp
  constexpr bool X = BlockSource<Phys>::kExact;
  static_assert(F >= 1 && F <= 32, "a node's lanes lie in one warp");
  // every lane of a warp takes part in the shuffles: a padding lane, or a
  // lane past the last node, repeats a live column and stores nothing
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int seg = lane / F < NPW ? lane / F : 0;   // the node's lanes
  const long raw = (t / 32) * NPW + seg;
  const bool owner = lane / F < NPW && raw < total;
  const long item = raw < total ? raw : total - 1;
  const int j = lane - seg * F < F ? lane - seg * F : lane - NPW * F;
  const int base = seg * F;    // the node's lane 0

  int l = 0;
  while (l + 1 < nlev && item >= __ldg(rec + (l + 1) * kBuildRecord + 2)) ++l;
  const long long* r = rec + l * kBuildRecord;
  const long nvert = __ldg(r), ncell = __ldg(r + 1);
  const long idx = item - __ldg(r + 2);
  const long long mask_off = __ldg(r + 4), src_off = __ldg(r + 5);
  const long long state_off = __ldg(r + 7);
  const bool on_v = idx < nvert;
  const long node = on_v ? idx : idx - nvert;
  const long n = on_v ? nvert : ncell;

  // the node's source in the finest level's planes
  const long nv0 = __ldg(rec), nc0 = __ldg(rec + 1);
  const long s = src_off < 0 ? idx : __ldg(src + src_off + idx);
  const bool s_v = s < nv0;
  const long sn = s_v ? nv0 : nc0;
  const long so = s_v ? s : s - nv0;
  const float* sw = s_v ? wv : wm;

  float u[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) u[k] = __ldg(sw + Phys::state_field(k) * sn + so);
  if (owner && state_off >= 0) {   // the injection: field j of w and w0
    const float* sw0 = s_v ? w0v : w0m;
    float* st = states + state_off + (on_v ? 0 : F * nvert);
    const long w0_off = F * (nvert + ncell);
    st[j * n + node] = __ldg(sw + j * sn + so);
    st[w0_off + j * n + node] = __ldg(sw0 + j * sn + so);
  }
  const float* dg = diag + __ldg(r + 3);
  const long N = nvert + ncell;
  const float mass = __ldg(dg + idx);
  const float sxx = __ldg(dg + N + idx);
  const float syy = __ldg(dg + 2 * N + idx);

  // column j of [P | I]: a[i] = P[i][j], b[i] = I[i][j]
  float a[F], b[F];
  {
    float e[F], z[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      e[k] = k == j ? 1.0f : 0.0f;
      z[k] = 0.0f;
    }
    float sc[F], fx[F], fy[F], s_[F], x_[F], y_[F];
    if constexpr (X)                            // the source column
      BlockSource<Phys>::column(P, u, j, sc);
    else
      Phys::tangent(P, u, e, z, z, sc, x_, y_);
    Phys::tangent(P, u, z, e, z, s_, fx, y_);   // flux x in gx = e_j
    Phys::tangent(P, u, z, z, e, s_, x_, fy);   // flux y in gy = e_j
#pragma unroll
    for (int i = 0; i < F; ++i) {
      if constexpr (X)
        a[i] = __fadd_rn(__fadd_rn(__fmul_rn(sc[i], mass),
                                   __fmul_rn(fx[i], sxx)),
                         __fmul_rn(fy[i], syy));
      else
        a[i] = sc[i] * mass + fx[i] * sxx + fy[i] * syy;
      b[i] = i == j ? 1.0f : 0.0f;
    }
  }
  if (on_v && mask_off >= 0) {
#pragma unroll
    for (int i = 0; i < F; ++i)
      if (__ldg(mask + mask_off + i * nvert + node) != 0.0f)
        a[i] = i == j ? 1.0f : 0.0f;
  }

  // small_inv, pivot by pivot: column i from lane i, row i / a[i][i], then
  // row r -= a[r][i] row i
#pragma unroll
  for (int i = 0; i < F; ++i) {
    float col[F];
#pragma unroll
    for (int rr = 0; rr < F; ++rr)
      col[rr] = __shfl_sync(0xffffffffu, a[rr], base + i);
    const float p = col[i];
    a[i] = a[i] / p;
    b[i] = b[i] / p;
#pragma unroll
    for (int rr = 0; rr < F; ++rr) {
      if (rr == i) continue;
      const float f = col[rr];
      if constexpr (X) {
        a[rr] = __fsub_rn(a[rr], __fmul_rn(f, a[i]));
        b[rr] = __fsub_rn(b[rr], __fmul_rn(f, b[i]));
      } else {
        a[rr] = a[rr] - f * a[i];
        b[rr] = b[rr] - f * b[i];
      }
    }
  }

  if (owner) {
    float* out = planes + __ldg(r + 6) + (on_v ? 0 : F * F * nvert);
#pragma unroll
    for (int i = 0; i < F; ++i) out[(i * F + j) * n + node] = b[i];
  }
}

// Host side: one launch over every level. params: the JvpParams floats
// (load_params; only the constants and dt are read); rec: nlev records on
// the card; total: the levels' nodes.
template <class Phys>
int node_build(const float* params, const long long* rec, int nlev,
               long total, const float* wv, const float* wm, const float* w0v,
               const float* w0m, const float* diag, const float* mask,
               const int* src, float* planes, float* states, void* stream) {
  if (nlev < 1 || total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const JvpParams P = load_params(params);
  constexpr int NPW = 32 / Phys::NF;
  node_build_kernel<Phys>
      <<<blocks_for((total + NPW - 1) / NPW * 32), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(P, rec, nlev, total, wv, wm,
                                              w0v, w0m, diag, mask, src,
                                              planes, states);
  return static_cast<int>(cudaGetLastError());
}

template <class Phys>
int node_build_info(int* out) {
  return kernel_info(node_build_kernel<Phys>, kThreads, 0, out);
}

}  // namespace pfh
