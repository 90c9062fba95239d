// Kernel W: the crossed-P1 J.v over shared-memory triangle boxes, templated
// on the physics; each triangle's quadrature-point tangent is evaluated once
// and every node is summed in the gather's order, so W gives the gather
// kernel's bits. The residual box (residual_box_kernel, below) is the same
// design over Phys::residual: kernel R's bits (fem_residual.cuh).
//
// Computes, as the gather body (fem_jvp.cuh) does,
//     out = J(w, dt) v        (b == nullptr), or   out = b - J(w, dt) v
// in f32 on the unpadded v and m planes of fem_params.cuh, at a 4-point rule
// (ffc3, the outer rule); with kMask, the Dirichlet rows of a 0/1 vertex
// mask as jvp_store has them (on a masked row the tangent value itself, then
// b - value where b is given), else none. It is the outer Krylov J.v and
// the exported A z of bench1 (ch_box.cu), bench2 (chac_box.cu) and bench3
// (ach_box.cu), in place of kernels A, F and G there, and the outer J.v of
// bench6 with its Dirichlet rows (chp_box.cu, kMask), in place of kernel E;
// all replace pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp
// (:198), whose BM6 rows the JAX package re-sets after the kernel
// (pfhubbenchmarks_tpu/benchmarks/base.py:201-215) as the masked store
// does. A, E, F and G stay built: every multigrid level, kernel L and the
// chains run the gather body.
//
// Why: a gather thread (one per node) evaluates the tangent of every
// triangle it touches, so each (triangle, point) tangent is evaluated once
// per node of the triangle, 3 times, and a vertex thread runs 8 triangles x
// 4 points = 32 tangents in one serial chain. The tangent and the slot
// arithmetic do not depend on the node; only the weights WB/WGx/WGy of the
// slot do.
//
// Design. A CTA owns a box of BY x BX vertices and the centres of the cells
// with the same indices, and evaluates the cells those nodes touch: the
// box's cells and one halo cell row below and column to the left, (BY+1) x
// (BX+1) cells, clipped to the grid. It
//   1. stages, by cp.async, the NS state planes and the NF tangent planes of
//      those cells' (BY+2) x (BX+2) vertices and (BY+1) x (BX+1) centres;
//   2. evaluates the cells, one thread per (cell, triangle) (or per point
//      group of it, QSPLIT): the triangle's gradients, then at each point the
//      state and tangent values and Phys::tangent, ONCE, and the point's term
//      for each of the triangle's 3 slots, WB*src + WGx*fx + WGy*fy as
//      slot_contrib writes it, into shared memory (12 NQ NF floats a cell);
//   3. after one barrier, one thread per owned node adds its terms in
//      jvp_node's order: for a vertex its cells SW, SE, NE, NW (the node as
//      slot 0, 1, 2, 3), in each the triangles holding the slot in
//      ascending order, in each the points in order; for a centre its cell's
//      four triangles and their points. Then the store of jvp_store.
// Every term is the value the gather computes for that (cell, triangle,
// point, slot), and every node adds the same terms from 0 in the same order,
// so W's sums are the gather's; no atomics, and two calls give the same
// bits.
//
// What bounds it on the H100: f32 operations by the count of chip_smoke.py
// (jvp_work: 2.57 us at bench3's 350^2, 0.75 us at bench2's 100^2); the
// staged operands are ~1.3x the planes' bytes, from L2. The shared terms
// (1,152 B a cell at F = 6, 384 B at F = 2) size the boxes: 7 x 7 at BM2
// (64 cells, 256 threads, ~80 KB, two CTAs per SM), 7 x 15 at BM3 (128
// cells, 512 threads, ~54 KB, held to 40 registers for three CTAs per SM).
// Measured on an H100 (80GB HBM3, 700 W; tools/torch_tri_box_probe.py): at
// bench2's 100^2 every box from 3 x 7 to 15 x 7 took 14.5-14.7 us against
// F's 37.2 (one wave of ~512 threads per SM, each a serial chain of 4
// tangents: latency-bound), and splitting the points over 2 or 4 threads
// per triangle was slower (23-66 us: the gradients and loads repeat, and the
// registers stay ~125); at bench3's 350^2 three CTAs per SM took 22.8 us
// against two CTAs' 25.5-28.8 and G's 23.6.
#pragma once

#include <cuda_pipeline.h>

#include "fem_params.cuh"

namespace pfh {

// The box of one physics: BY x BX owned vertices (and centres); the points
// of a triangle split over QSPLIT threads (1, 2 or 4 at 4 points).
template <int BY_, int BX_, int MIN_CTAS_, int QSPLIT_>
struct TriBox {
  static constexpr int BY = BY_, BX = BX_;
  static constexpr int kMinCtas = MIN_CTAS_;   // __launch_bounds__
  static constexpr int kQSplit = QSPLIT_;
  static constexpr int kCY = BY + 1, kCX = BX + 1;   // evaluated cells
  static constexpr int kVY = BY + 2, kVX = BX + 2;   // staged vertices
  static constexpr int kCells = kCY * kCX;
  static constexpr int kVerts = kVY * kVX;
  static constexpr int kPlane = kVerts + kCells;     // one staged plane
  static constexpr int kOwned = BY * BX;
  // one per (cell, triangle, point group)
  static constexpr int kThreads = 4 * kQSplit * kCells;
};

// Vertex slot j (0, 1) of triangle t, ascending: S (0, 1), E (1, 2),
// N (2, 3), W (0, 3); its third slot is the centre, 4.
__host__ __device__ constexpr int tri_vslot(int t, int j) {
  return t == 3 ? (j == 0 ? 0 : 3) : t + j;
}

// shared floats of one box: the staged planes, then the terms
template <class Phys, int NQ, class Box>
constexpr int tri_box_floats() {
  return (Phys::NS + Phys::NF) * Box::kPlane + 12 * NQ * Phys::NF * Box::kCells;
}

// The boxes of a grid of ny x nx cells: ceil((n + 1) / B) along each axis.
template <class Box>
__host__ __device__ inline int tri_boxes(int ny, int nx) {
  return ((ny + Box::BY) / Box::BY) * ((nx + Box::BX) / Box::BX);
}

// The terms of triangle T of one cell at the points of group qg (points
// qg NQ / QSPLIT onward): ss the staged planes (NS state, then NF tangent),
// v0 the staged index of the cell's slot-0 vertex, lc its local index; term
// (T, q, j, f) at terms[((T NQ + q) 3 + j) NF + f) kCells + lc], j = 0, 1
// the vertex slots tri_vslot(T, j), j = 2 the centre. The arithmetic is
// slot_contrib's (fem_jvp.cuh), statement for statement.
template <class Phys, int NQ, int T, class Box>
__device__ __forceinline__ void tri_terms(const JvpParams& P,
                                          const float* __restrict__ ss,
                                          int v0, int lc, int qg,
                                          float* __restrict__ terms) {
  constexpr int NF = Phys::NF;
  constexpr int NS = Phys::NS;
  constexpr int kQPer = NQ / Box::kQSplit;
  static_assert(NQ % Box::kQSplit == 0, "the point groups split NQ evenly");
  const int off[5] = {v0, v0 + 1, v0 + Box::kVX + 1, v0 + Box::kVX,
                      Box::kVerts + lc};
  float wc[NS][5], d[NF][5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
#pragma unroll
    for (int f = 0; f < NS; ++f) wc[f][s] = ss[f * Box::kPlane + off[s]];
#pragma unroll
    for (int f = 0; f < NF; ++f) d[f][s] = ss[(NS + f) * Box::kPlane + off[s]];
  }
  float gx[NF], gy[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) gx[f] = gy[f] = 0.f;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      gx[f] += P.Gs[T][s][0] * d[f][s];
      gy[f] += P.Gs[T][s][1] * d[f][s];
    }
  }
  [[maybe_unused]] typename TriOf<Phys>::type tri;
  if constexpr (kReadsStateGrad<Phys>) {
    float ugx[NS], ugy[NS];
    state_grad<NS>(P, T, wc, ugx, ugy);
    tri = Phys::tri(P, ugx, ugy);
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q / kQPer != qg) continue;
    float u[NS], dq[NF];
#pragma unroll
    for (int f = 0; f < NS; ++f) u[f] = 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) dq[f] = 0.f;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
#pragma unroll
      for (int f = 0; f < NS; ++f) u[f] += P.Bq[T][q][s] * wc[f][s];
#pragma unroll
      for (int f = 0; f < NF; ++f) dq[f] += P.Bq[T][q][s] * d[f][s];
    }
    float src[NF], fx[NF], fy[NF];
    if constexpr (kReadsStateGrad<Phys>)
      Phys::tangent(P, u, tri, dq, gx, gy, src, fx, fy);
    else
      Phys::tangent(P, u, dq, gx, gy, src, fx, fy);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int S = j < 2 ? tri_vslot(T, j) : 4;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        terms[(((T * NQ + q) * 3 + j) * NF + f) * Box::kCells + lc] =
            P.WB[T][q][S] * src[f] + P.WGx[T][q][S] * fx[f]
            + P.WGy[T][q][S] * fy[f];
    }
  }
}

// Adds the terms of slot S of local cell lc into acc, triangles holding S
// in ascending order, points in order (slot_contrib's order).
template <int NF, int NQ, int S, class Box>
__device__ __forceinline__ void add_slot(const float* __restrict__ terms,
                                         int lc, float (&acc)[NF]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (!slot_in_tri(t, S)) continue;
    const int j = S == 4 ? 2 : (tri_vslot(t, 0) == S ? 0 : 1);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int f = 0; f < NF; ++f)
        acc[f] += terms[(((t * NQ + q) * 3 + j) * NF + f) * Box::kCells + lc];
    }
  }
}

// Phase 1 of a box: stage NP planes of the cells the box evaluates, by
// cp.async: staged vertex (ly, lx) is global vertex (oy - 1 + ly, ox - 1 +
// lx), staged centre likewise (outside the grid nothing is copied: no cell
// in the grid reads there). plane(p, vert) is the global vertex (vert) or
// centre plane of staged plane p.
template <class Box, int NP, class Plane>
__device__ __forceinline__ void stage_box(float* __restrict__ ss, int oy,
                                          int ox, int ny, int nx,
                                          Plane plane) {
  const int nvx = nx + 1;
  for (int k = threadIdx.x; k < NP * Box::kPlane; k += blockDim.x) {
    const int p = k / Box::kPlane, i = k % Box::kPlane;
    const bool vert = i < Box::kVerts;
    const int li = vert ? i : i - Box::kVerts;
    const int w = vert ? Box::kVX : Box::kCX;
    const int gy = oy - 1 + li / w, gx = ox - 1 + li % w;
    if (gy < 0 || gx < 0 || gy > ny - !vert || gx > nx - !vert) continue;
    __pipeline_memcpy_async(ss + k,
                            plane(p, vert) + (vert ? gy * nvx : gy * nx) + gx,
                            sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Phase 2's thread: its triangle t, point group qg, local cell lc and the
// staged index v0 of the cell's slot-0 vertex; false for a cell outside
// the grid.
template <class Box>
__device__ __forceinline__ bool box_cell(int oy, int ox, int ny, int nx,
                                         int& t, int& qg, int& lc, int& v0) {
  t = threadIdx.x / (Box::kQSplit * Box::kCells);
  qg = (threadIdx.x / Box::kCells) % Box::kQSplit;
  lc = threadIdx.x % Box::kCells;
  const int ly = lc / Box::kCX, lx = lc % Box::kCX;
  const int cy = oy - 1 + ly, cx = ox - 1 + lx;
  v0 = ly * Box::kVX + lx;
  return cy >= 0 && cx >= 0 && cy < ny && cx < nx;
}

// Phase 3: one thread per owned node adds its terms in the gather's order
// (jvp_node, fem_residual_kernel): a vertex its cells SW, SE, NE, NW (the
// node as slot 0, 1, 2, 3), a centre its cell; then store(vert, i, acc),
// i the vertex's or the centre's index in its plane.
template <int NF, int NQ, class Box, class Store>
__device__ __forceinline__ void sum_owned(const float* __restrict__ terms,
                                          int oy, int ox, int ny, int nx,
                                          Store store) {
  for (int k = threadIdx.x; k < 2 * Box::kOwned; k += blockDim.x) {
    const bool vert = k < Box::kOwned;
    const int kk = vert ? k : k - Box::kOwned;
    const int py = kk / Box::BX, px = kk % Box::BX;
    const int y = oy + py, x = ox + px;
    // the local index of the cell at global (y, x): local (py + 1, px + 1)
    const int lc = (py + 1) * Box::kCX + (px + 1);
    float acc[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] = 0.f;
    if (vert) {
      if (y > ny || x > nx) continue;
      // the node is slot SW of cell (y, x), SE of (y, x-1), NE of
      // (y-1, x-1) and NW of (y-1, x)
      if (y < ny && x < nx) add_slot<NF, NQ, 0, Box>(terms, lc, acc);
      if (y < ny && x > 0) add_slot<NF, NQ, 1, Box>(terms, lc - 1, acc);
      if (y > 0 && x > 0)
        add_slot<NF, NQ, 2, Box>(terms, lc - Box::kCX - 1, acc);
      if (y > 0 && x < nx) add_slot<NF, NQ, 3, Box>(terms, lc - Box::kCX, acc);
      store(true, static_cast<long>(y) * (nx + 1) + x, acc);
    } else {
      if (y >= ny || x >= nx) continue;
      add_slot<NF, NQ, 4, Box>(terms, lc, acc);
      store(false, static_cast<long>(y) * nx + x, acc);
    }
  }
}

template <class Phys, int NQ, class Box, bool kMask>
__global__ void __launch_bounds__(Box::kThreads, Box::kMinCtas)
tri_box_kernel(const JvpParams P, const float* __restrict__ wv,
               const float* __restrict__ wm, const float* __restrict__ tv,
               const float* __restrict__ tm, const float* __restrict__ bv,
               const float* __restrict__ bm, const float* __restrict__ mask,
               float* __restrict__ ov, float* __restrict__ om, int ny,
               int nx) {
  constexpr int NF = Phys::NF;
  constexpr int NS = Phys::NS;
  extern __shared__ float tri_smem[];
  float* ss = tri_smem;                                // (NS + NF) planes
  float* terms = ss + (NS + NF) * Box::kPlane;         // 12 NQ NF kCells
  const int nbx = (nx + Box::BX) / Box::BX;
  const int oy = (blockIdx.x / nbx) * Box::BY;
  const int ox = (blockIdx.x % nbx) * Box::BX;
  const long nvert = static_cast<long>(ny + 1) * (nx + 1);
  const long ncell = static_cast<long>(ny) * nx;

  // 1. the NS state planes, then the NF tangent planes
  stage_box<Box, NS + NF>(ss, oy, ox, ny, nx, [&](int p, bool vert) {
    return p < NS ? (vert ? wv : wm) + Phys::state_field(p) * (vert ? nvert : ncell)
                  : (vert ? tv : tm) + (p - NS) * (vert ? nvert : ncell);
  });

  // 2. one thread per (cell, triangle, point group): its terms
  {
    int t, qg, lc, v0;
    if (box_cell<Box>(oy, ox, ny, nx, t, qg, lc, v0)) {
      switch (t) {
        case 0: tri_terms<Phys, NQ, 0, Box>(P, ss, v0, lc, qg, terms); break;
        case 1: tri_terms<Phys, NQ, 1, Box>(P, ss, v0, lc, qg, terms); break;
        case 2: tri_terms<Phys, NQ, 2, Box>(P, ss, v0, lc, qg, terms); break;
        default: tri_terms<Phys, NQ, 3, Box>(P, ss, v0, lc, qg, terms); break;
      }
    }
  }
  __syncthreads();

  // 3. one thread per owned node: its terms in jvp_node's order, then the
  // store of jvp_store (with kMask, a masked vertex row the tangent value)
  sum_owned<NF, NQ, Box>(terms, oy, ox, ny, nx,
                         [&](bool vert, long i, const float (&acc)[NF]) {
    const float* b = vert ? bv : bm;
    float* o = vert ? ov : om;
    const long n = vert ? nvert : ncell;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float val = acc[f];
      if constexpr (kMask) {
        if (vert && mask != nullptr && __ldg(mask + f * n + i) != 0.f)
          val = __ldg(tv + f * n + i);
      }
      o[f * n + i] = (b != nullptr) ? __ldg(b + f * n + i) - val : val;
    }
  });
}

// The dynamic shared bytes of one instantiation of kernel W, allowed once
// (above 48 KB a kernel must ask for them).
template <class Phys, int NQ, class Box, bool kMask>
inline cudaError_t tri_box_smem(int* bytes) {
  *bytes = static_cast<int>(sizeof(float)) * tri_box_floats<Phys, NQ, Box>();
  static const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(tri_box_kernel<Phys, NQ, Box, kMask>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  return err;
}

// Host launcher: params as launch_fem_jvp's (fem_jvp.cuh); by, bx the box
// the caller planned with, which must be Box's; mask the Dirichlet vertex
// mask or null, which only a kMask instantiation takes. One CTA per box.
// Takes the 4-point rule only.
template <class Phys, class Box, bool kMask = false>
int launch_tri_box(const float* params, int nq, int by, int bx,
                   const float* wv, const float* wm, const float* tv,
                   const float* tm, const float* bv, const float* bm,
                   const float* mask, float* ov, float* om, int ny, int nx,
                   void* stream) {
  if (nq != 4 || by != Box::BY || bx != Box::BX
      || (!kMask && mask != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int bytes = 0;
  const cudaError_t err = tri_box_smem<Phys, 4, Box, kMask>(&bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const JvpParams P = load_params(params);
  tri_box_kernel<Phys, 4, Box, kMask>
      <<<tri_boxes<Box>(ny, nx), Box::kThreads, bytes,
         static_cast<cudaStream_t>(stream)>>>(P, wv, wm, tv, tm, bv, bm, mask,
                                              ov, om, ny, nx);
  return static_cast<int>(cudaGetLastError());
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of W
// (common.cuh kernel_info).
template <class Phys, class Box, bool kMask = false>
int tri_box_info(int* out) {
  int bytes = 0;
  const cudaError_t err = tri_box_smem<Phys, 4, Box, kMask>(&bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return kernel_info(tri_box_kernel<Phys, 4, Box, kMask>, Box::kThreads, bytes,
                     out);
}

// ---- The residual box: kernel R's residual over triangle boxes -----------
//
// Computes, as fem_residual_kernel (fem_residual.cuh) does,
//     out = R(w, w0, dt)
// in f32, with the Dirichlet rows (mask != 0) u - g, at the 4-point rule.
// It is the f32 residual of the cp line search and its noise floor
// (solve/newton.py) of bench2 and bench2_eta1 (chac_rbox.cu) and bench6
// (chp_rbox.cu), in place of kernel R there; it replaces
// pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_residual (:226).
// The design is W's: the NF planes of w and the NF planes of w0 staged,
// one thread per (cell, triangle) that computes the triangle's gradients
// once and Phys::residual once per point, writing the triangle's 3 slot
// terms (cell_residual's expression, statement for statement) into shared
// memory, then one thread per owned node adding its terms in
// fem_residual_kernel's order. So the residual box gives R's bits.

// shared floats of one residual box: 2 NF staged planes, then the terms
template <class Phys, int NQ, class Box>
constexpr int residual_box_floats() {
  return 2 * Phys::NF * Box::kPlane + 12 * NQ * Phys::NF * Box::kCells;
}

// The residual terms of triangle T of one cell at the points of group qg:
// ss the staged planes (NF of w, then NF of w0), v0, lc and the terms'
// layout as tri_terms'. The arithmetic is cell_residual's
// (fem_residual.cuh), statement for statement.
template <class Phys, int NQ, int T, class Box>
__device__ __forceinline__ void tri_residual_terms(
    const JvpParams& P, const float* __restrict__ ss, int v0, int lc, int qg,
    float* __restrict__ terms) {
  constexpr int NF = Phys::NF;
  constexpr int kQPer = NQ / Box::kQSplit;
  static_assert(NQ % Box::kQSplit == 0, "the point groups split NQ evenly");
  const int off[5] = {v0, v0 + 1, v0 + Box::kVX + 1, v0 + Box::kVX,
                      Box::kVerts + lc};
  float wc[NF][5], w0c[NF][5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wc[f][s] = ss[f * Box::kPlane + off[s]];
      w0c[f][s] = ss[(NF + f) * Box::kPlane + off[s]];
    }
  }
  float gx[NF], gy[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) gx[f] = gy[f] = 0.f;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      gx[f] += P.Gs[T][s][0] * wc[f][s];
      gy[f] += P.Gs[T][s][1] * wc[f][s];
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (q / kQPer != qg) continue;
    float u[NF], u0[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) u[f] = u0[f] = 0.f;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        u[f] += P.Bq[T][q][s] * wc[f][s];
        u0[f] += P.Bq[T][q][s] * w0c[f][s];
      }
    }
    float src[NF], fx[NF], fy[NF];
    Phys::residual(P, u, gx, gy, u0, src, fx, fy);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int S = j < 2 ? tri_vslot(T, j) : 4;
#pragma unroll
      for (int f = 0; f < NF; ++f)
        terms[(((T * NQ + q) * 3 + j) * NF + f) * Box::kCells + lc] =
            P.WB[T][q][S] * src[f] + P.WGx[T][q][S] * fx[f]
            + P.WGy[T][q][S] * fy[f];
    }
  }
}

template <class Phys, int NQ, class Box>
__global__ void __launch_bounds__(Box::kThreads, Box::kMinCtas)
residual_box_kernel(const JvpParams P, const float* __restrict__ wv,
                    const float* __restrict__ wm,
                    const float* __restrict__ w0v,
                    const float* __restrict__ w0m,
                    const float* __restrict__ mask,
                    const float* __restrict__ gv, float* __restrict__ ov,
                    float* __restrict__ om, int ny, int nx) {
  constexpr int NF = Phys::NF;
  extern __shared__ float tri_smem[];
  float* ss = tri_smem;                                // 2 NF planes
  float* terms = ss + 2 * NF * Box::kPlane;            // 12 NQ NF kCells
  const int nbx = (nx + Box::BX) / Box::BX;
  const int oy = (blockIdx.x / nbx) * Box::BY;
  const int ox = (blockIdx.x % nbx) * Box::BX;
  const long nvert = static_cast<long>(ny + 1) * (nx + 1);
  const long ncell = static_cast<long>(ny) * nx;

  // 1. the NF planes of w, then the NF planes of w0
  stage_box<Box, 2 * NF>(ss, oy, ox, ny, nx, [&](int p, bool vert) {
    return (p < NF ? (vert ? wv : wm) : (vert ? w0v : w0m))
           + (p % NF) * (vert ? nvert : ncell);
  });

  // 2. one thread per (cell, triangle, point group): its terms
  {
    int t, qg, lc, v0;
    if (box_cell<Box>(oy, ox, ny, nx, t, qg, lc, v0)) {
      switch (t) {
        case 0:
          tri_residual_terms<Phys, NQ, 0, Box>(P, ss, v0, lc, qg, terms);
          break;
        case 1:
          tri_residual_terms<Phys, NQ, 1, Box>(P, ss, v0, lc, qg, terms);
          break;
        case 2:
          tri_residual_terms<Phys, NQ, 2, Box>(P, ss, v0, lc, qg, terms);
          break;
        default:
          tri_residual_terms<Phys, NQ, 3, Box>(P, ss, v0, lc, qg, terms);
          break;
      }
    }
  }
  __syncthreads();

  // 3. one thread per owned node: its terms in fem_residual_kernel's order,
  // then its store (a Dirichlet row is w - g)
  sum_owned<NF, NQ, Box>(terms, oy, ox, ny, nx,
                         [&](bool vert, long i, const float (&acc)[NF]) {
    if (vert) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const long o = f * nvert + i;
        ov[o] = (mask != nullptr && __ldg(mask + o) != 0.f)
                    ? __ldg(wv + o) - __ldg(gv + o) : acc[f];
      }
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f) om[f * ncell + i] = acc[f];
    }
  });
}

// The dynamic shared bytes of one instantiation of the residual box,
// allowed once.
template <class Phys, int NQ, class Box>
inline cudaError_t residual_box_smem(int* bytes) {
  *bytes = static_cast<int>(sizeof(float)) * residual_box_floats<Phys, NQ, Box>();
  static const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(residual_box_kernel<Phys, NQ, Box>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  return err;
}

// Host launcher: params as launch_fem_residual's (fem_residual.cuh); mask
// and gv both null (no Dirichlet rows) or both given; by, bx the box the
// caller planned with, which must be Box's. One CTA per box, the 4-point
// rule only.
template <class Phys, class Box>
int launch_residual_box(const float* params, int nq, int by, int bx,
                        const float* wv, const float* wm, const float* w0v,
                        const float* w0m, const float* mask, const float* gv,
                        float* ov, float* om, int ny, int nx, void* stream) {
  if (nq != 4 || by != Box::BY || bx != Box::BX
      || (mask == nullptr) != (gv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int bytes = 0;
  const cudaError_t err = residual_box_smem<Phys, 4, Box>(&bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const JvpParams P = load_params(params);
  residual_box_kernel<Phys, 4, Box>
      <<<tri_boxes<Box>(ny, nx), Box::kThreads, bytes,
         static_cast<cudaStream_t>(stream)>>>(P, wv, wm, w0v, w0m, mask, gv,
                                              ov, om, ny, nx);
  return static_cast<int>(cudaGetLastError());
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of the
// residual box (common.cuh kernel_info).
template <class Phys, class Box>
int residual_box_info(int* out) {
  int bytes = 0;
  const cudaError_t err = residual_box_smem<Phys, 4, Box>(&bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return kernel_info(residual_box_kernel<Phys, 4, Box>, Box::kThreads, bytes,
                     out);
}

}  // namespace pfh
