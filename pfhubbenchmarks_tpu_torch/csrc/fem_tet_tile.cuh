// Kernel U: the J.v of a Kuhn-tet P1 weak form in 3D over shared-memory tet
// boxes, templated on the physics; every tet of a box is evaluated once.
//
// Computes, as kernel I (fem_jvp3d.cuh) does,
//     out = J(w, dt) v        (b == nullptr), or   out = b - J(w, dt) v
// in f32 on one vertex grid [F, nz+1, ny+1, nx+1] at 1, 4 or 8 points, from
// the same parameter block (Jvp3Params). Replaces, with kernel I kept beside
// it as the gather form, pfhubbenchmarks_tpu/ops/pallas3d.py:
// make_tiled_jvp3d (:294), whose z slabs evaluate each cell once with one
// halo cell row on each side and keep the rows they own, and
// make_pallas_jvp3d (:149). tet_box() is also kernel L's 3D A z
// (lmr_loop.cuh, Level3).
//
// Design. A CTA owns a box of kBoxX x kBoxY x kBoxZ vertices and takes the
// cells incident to them: the box's cells and one halo cell layer below it
// on each axis, (kBoxX+1)(kBoxY+1)(kBoxZ+1) cells, clipped to the grid. It
//   1. stages, once from global memory, the state plane and the NF tangent
//      planes of those cells' (kBoxX+2)(kBoxY+2)(kBoxZ+2) vertices;
//   2. evaluates the cells, one thread per cell: each of the cell's 6 tets
//      once, in order; per tet its gradients, then at each point the state
//      and tangent values and Phys::tangent, ONCE, and from them the tet's 4
//      vertex rows: the source part sum_q WB[T][q][K] src_q, and the flux
//      part contracted once per tet, sum_a Gs[T][K][a] Phi[a] with
//      Phi = sum_q w_q flux_q (P1 gradients are constant on a tet, so
//      WG[T][q][K][a] = w_q Gs[T][K][a]; w_q = sum_K WB[T][q][K], as the
//      barycentric values sum to 1). The rows go straight into the cell's 8
//      slot sums, in registers, which the thread writes to shared memory;
//   3. after a barrier, one thread per owned vertex sums its (up to) 8
//      cells' slot sums and writes the vertex's rows.
// Fixed order, no atomics: a vertex's value is
//     sum over slot s = 0..7 of (its cell at slot s, when in the grid)
//       sum over tets t = 0..5 that contain s, in order, of
//         (sum over points q in order of WB[t][q][K] src_q)
//           + (Gs[t][K][0] Phi_0 + Gs[t][K][1] Phi_1 + Gs[t][K][2] Phi_2)
// each sum from 0 and left to right; two calls give the same bits. Kernel I
// sums the same terms in one running sum per node (cells by slot, tets,
// points) with WG, so the two differ in rounding.
//
// Why a thread per cell and not per (cell, tet): a thread's chain is the
// box's tets over the CTA's threads in either split (here 3,072 / 256 = 12
// tets); split by tet, the rows make a round trip through shared memory, a
// combine pass and two barriers per chunk of cells are added, and six tet
// bodies run at once in a CTA. Measured on an H100 (80GB HBM3, 700 W) at
// keast2 with 8x8x5 boxes, the tet split took 31.7 us at 50^3 and 13.4 us
// at 25^3, one thread per cell 21.9 and 8.9, with the same bits.
//
// What bounds it on the H100: operations. At bench1_3d's 50^3 (125,000
// cells, 512 boxes of 7^3 vertices) a launch reads ~1.6 MB (2.1 MB with b)
// and writes ~1.1 MB, L2-resident, and evaluates 1.482 x the grid's
// 750,000 tets (the halo layers), each tet once where kernel I evaluated
// every tet once per vertex (4 times). A box's 512 cells take two rounds of
// 256 threads; the staged operands are ~1.5x the planes' bytes, from L2;
// per box 2 barriers. At 8 points the kernel is held to Phys::kTetMinCtas8
// CTAs per SM: CH3 three (80 registers and ~170 bytes of stack), which
// measured faster than the unbounded body at one CTA per SM; CHP3 one (226
// registers, no spills), which measured 62.3 us at bench6_3d's 50^3 and 17.9
// at 25^3 against 62.6 / 22.5 at two CTAs (128 registers, 320 bytes of stack)
// and 86.0 / 28.1 at three (tools/torch_tile_probe.py bound; NVIDIA H100 80GB
// HBM3, 700 W).
//
// Dirichlet rows (kMask, bench6_3d's phi faces): with kMask a vertex whose
// mask entry ([F, nz+1, ny+1, nx+1], 0/1) is nonzero stores the tangent
// value v (or b - v) in place of its assembled sum: the J.v of a residual
// whose row there is u - g, as the 2D box's store does (fem_tri_box.cuh
// tri_box_kernel). The mask is read in phase 3 only, so the assembled rows
// and their order do not change; without kMask the store is the one before.
#pragma once

#include "fem_jvp3d.cuh"

namespace pfh {

// Owned vertices of a box, along x, y, z (ops/fem_jvp3d.py TET_BOX).
constexpr int kBoxX = 7;
constexpr int kBoxY = 7;
constexpr int kBoxZ = 7;
constexpr int kBoxCX = kBoxX + 1, kBoxCY = kBoxY + 1, kBoxCZ = kBoxZ + 1;
constexpr int kBoxVX = kBoxX + 2, kBoxVY = kBoxY + 2, kBoxVZ = kBoxZ + 2;
constexpr int kBoxCells = kBoxCX * kBoxCY * kBoxCZ;  // 512
constexpr int kBoxVerts = kBoxVX * kBoxVY * kBoxVZ;  // 729
constexpr int kBoxOwned = kBoxX * kBoxY * kBoxZ;     // 343
constexpr int kTetThreads = 256;  // kernel U's CTA (and kernel L's)

// shared floats of one box: the staged planes and the cells' slot sums
template <class Phys>
constexpr int tet_box_floats() {
  return (Phys::NS + Phys::NF) * kBoxVerts + kBoxCells * 8 * Phys::NF;
}

// The boxes of a grid of nz x ny x nx cells: along each axis
// ceil((n + 1) / kBox) boxes; box b is (bz, by, bx), x fastest.
__host__ __device__ inline long tet_boxes(int nz, int ny, int nx) {
  return static_cast<long>((nz + kBoxZ) / kBoxZ) * ((ny + kBoxY) / kBoxY)
         * ((nx + kBoxX) / kBoxX);
}

// The 4 rows of tet T of one cell, every field, from the staged planes (sw
// NS state planes and sd NF tangent planes of kBoxVerts floats, v0 the
// staged index of the cell's slot 0), added into the cell's slot sums acc.
template <class Phys, int NQ, int T>
__device__ __forceinline__ void tet_rows(const Jvp3Params& P,
                                         const float* __restrict__ sw,
                                         const float* __restrict__ sd, int v0,
                                         float (&acc)[8][Phys::NF]) {
  constexpr int NF = Phys::NF;
  constexpr int NS = Phys::NS;
  float wc[NS][4], d[NF][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = tet_vert(T, j);
    const int o = v0 + (s >> 2) * (kBoxVY * kBoxVX) + ((s >> 1) & 1) * kBoxVX
                  + (s & 1);
#pragma unroll
    for (int f = 0; f < NS; ++f) wc[f][j] = sw[f * kBoxVerts + o];
#pragma unroll
    for (int f = 0; f < NF; ++f) d[f][j] = sd[f * kBoxVerts + o];
  }
  float g[NF][3];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += P.Gs[T][j][a] * d[f][j];
      g[f][a] = s;
    }
  }
  float r[4][NF], phi[NF][3];
#pragma unroll
  for (int f = 0; f < NF; ++f) {
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k][f] = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) phi[f][a] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float u[NS], dq[NF];
#pragma unroll
    for (int f = 0; f < NS; ++f) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += P.Bq[q][j] * wc[f][j];
      u[f] = s;
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += P.Bq[q][j] * d[f][j];
      dq[f] = s;
    }
    float src[NF], flux[NF][3];
    Phys::tangent(P, u, dq, g, src, flux);
    const float wq = P.WB[T][q][0] + P.WB[T][q][1] + P.WB[T][q][2]
                     + P.WB[T][q][3];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int a = 0; a < 3; ++a) phi[f][a] += wq * flux[f][a];
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k][f] += P.WB[T][q][k] * src[f];
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
      acc[tet_vert(T, k)][f] +=
          r[k][f] + (P.Gs[T][k][0] * phi[f][0] + P.Gs[T][k][1] * phi[f][1]
                     + P.Gs[T][k][2] * phi[f][2]);
  }
}

// Box b of the grid: out = J v (or b - J v) at its owned vertices. The state
// plane is read through the read-only cache, the tangent plane tv by Ld
// (LoadRO, or LoadCG for kernel L's z, written earlier in the launch). smem:
// tet_box_floats<Phys>() floats. Every thread of the CTA calls it with the
// same b; it holds 2 barriers and needs none before the next box's call.
// With kMask a nonzero entry of mask (null: none) makes the row v's.
template <class Phys, int NQ, bool kMask, class Ld>
__device__ __forceinline__ void tet_box(const Jvp3Params& P,
                                        const float* __restrict__ wv,
                                        const float* __restrict__ tv,
                                        const float* __restrict__ bv,
                                        const float* __restrict__ mask,
                                        float* __restrict__ ov, int nz, int ny,
                                        int nx, long b, float* smem) {
  constexpr int NF = Phys::NF;
  constexpr int NS = Phys::NS;
  float* sw = smem;                                  // NS x kBoxVerts
  float* sd = sw + NS * kBoxVerts;                   // NF x kBoxVerts
  float* cs = sd + NF * kBoxVerts;                   // [8][NF][kBoxCells]
  const int nbx = (nx + kBoxX) / kBoxX, nby = (ny + kBoxY) / kBoxY;
  const int bx = static_cast<int>(b % nbx);
  const int by = static_cast<int>((b / nbx) % nby);
  const int bz = static_cast<int>(b / (static_cast<long>(nbx) * nby));
  // local index l along an axis is global vertex (and cell) o - 1 + l
  const int ox = bx * kBoxX, oy = by * kBoxY, oz = bz * kBoxZ;
  const int nvx = nx + 1, nvy = ny + 1;
  const long nvert = static_cast<long>(nz + 1) * nvy * nvx;

  // 1. stage the planes of the box's vertices (0 outside the grid)
  for (int k = threadIdx.x; k < kBoxVerts; k += blockDim.x) {
    const int gx = ox - 1 + k % kBoxVX;
    const int gy = oy - 1 + (k / kBoxVX) % kBoxVY;
    const int gz = oz - 1 + k / (kBoxVX * kBoxVY);
    const bool in = gx >= 0 && gx <= nx && gy >= 0 && gy <= ny && gz >= 0
                    && gz <= nz;
    const long o = in ? (static_cast<long>(gz) * nvy + gy) * nvx + gx : 0;
#pragma unroll
    for (int f = 0; f < NS; ++f)
      sw[f * kBoxVerts + k] = in ? __ldg(wv + Phys::state_field(f) * nvert + o)
                                 : 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      sd[f * kBoxVerts + k] = in ? Ld::ld(tv + f * nvert + o) : 0.f;
  }
  __syncthreads();

  // 2. one thread per cell: its 6 tets in order into its 8 slot sums
  for (int lc = threadIdx.x; lc < kBoxCells; lc += blockDim.x) {
    const int lx = lc % kBoxCX, ly = (lc / kBoxCX) % kBoxCY,
              lz = lc / (kBoxCX * kBoxCY);
    const int gx = ox - 1 + lx, gy = oy - 1 + ly, gz = oz - 1 + lz;
    if (gx < 0 || gx >= nx || gy < 0 || gy >= ny || gz < 0 || gz >= nz)
      continue;
    const int v0 = (lz * kBoxVY + ly) * kBoxVX + lx;
    float acc[8][NF];
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[s][f] = 0.f;
    tet_rows<Phys, NQ, 0>(P, sw, sd, v0, acc);
    tet_rows<Phys, NQ, 1>(P, sw, sd, v0, acc);
    tet_rows<Phys, NQ, 2>(P, sw, sd, v0, acc);
    tet_rows<Phys, NQ, 3>(P, sw, sd, v0, acc);
    tet_rows<Phys, NQ, 4>(P, sw, sd, v0, acc);
    tet_rows<Phys, NQ, 5>(P, sw, sd, v0, acc);
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int f = 0; f < NF; ++f) cs[(s * NF + f) * kBoxCells + lc] = acc[s][f];
  }
  __syncthreads();

  // 3. the owned vertices: their cells' slot sums, slot by slot
  for (int k = threadIdx.x; k < kBoxOwned; k += blockDim.x) {
    const int px = k % kBoxX, py = (k / kBoxX) % kBoxY, pz = k / (kBoxX * kBoxY);
    const int vx = ox + px, vy = oy + py, vz = oz + pz;
    if (vx > nx || vy > ny || vz > nz) continue;
    float acc[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[f] = 0.f;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int dx = s & 1, dy = (s >> 1) & 1, dz = s >> 2;
      const int cx = vx - dx, cy = vy - dy, cz = vz - dz;
      if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz)
        continue;
      // the cell's local index: global cell o - 1 + l
      const int lc = ((pz + 1 - dz) * kBoxCY + (py + 1 - dy)) * kBoxCX
                     + (px + 1 - dx);
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[f] += cs[(s * NF + f) * kBoxCells + lc];
    }
    const long node = (static_cast<long>(vz) * nvy + vy) * nvx + vx;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const long o = f * nvert + node;
      float val = acc[f];
      if constexpr (kMask) {
        if (mask != nullptr && __ldg(mask + o) != 0.f) val = Ld::ld(tv + o);
      }
      ov[o] = (bv != nullptr) ? __ldg(bv + o) - val : val;
    }
  }
}

// At 8 points held to Phys::kTetMinCtas8 CTAs per SM (see the header).
template <class Phys, int NQ, bool kMask>
__global__ void __launch_bounds__(kTetThreads, NQ >= 8 ? Phys::kTetMinCtas8 : 1)
tet_tile_kernel(const Jvp3Params P, const float* __restrict__ wv,
                const float* __restrict__ tv, const float* __restrict__ bv,
                const float* __restrict__ mask, float* __restrict__ ov, int nz,
                int ny, int nx) {
  extern __shared__ float tet_smem[];
  tet_box<Phys, NQ, kMask, LoadRO>(P, wv, tv, bv, mask, ov, nz, ny, nx,
                                   blockIdx.x, tet_smem);
}

// The dynamic shared bytes of one instantiation of kernel U, allowed once
// (above 48 KB a kernel must ask for them).
template <class Phys, int NQ, bool kMask>
inline cudaError_t tet_tile_smem(int* bytes) {
  *bytes = static_cast<int>(sizeof(float)) * tet_box_floats<Phys>();
  static const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(tet_tile_kernel<Phys, NQ, kMask>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  return err;
}

template <class Phys, int NQ, bool kMask>
int launch_tet_tile_nq(const Jvp3Params& P, const float* wv, const float* tv,
                       const float* bv, const float* mask, float* ov, int nz,
                       int ny, int nx, cudaStream_t s) {
  int bytes = 0;
  const cudaError_t err = tet_tile_smem<Phys, NQ, kMask>(&bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* k = tet_tile_kernel<Phys, NQ, kMask>;
  k<<<static_cast<unsigned>(tet_boxes(nz, ny, nx)), kTetThreads, bytes, s>>>(
      P, wv, tv, bv, mask, ov, nz, ny, nx);
  return static_cast<int>(cudaGetLastError());
}

// Host launcher, with launch_fem_jvp3d's arguments and the Dirichlet mask
// after b (null: none; an instantiation without kMask refuses one): one CTA
// per box.
template <class Phys, bool kMask>
int launch_tet_tile(const float* params, int nq, const float* wv,
                    const float* tv, const float* bv, const float* mask,
                    float* ov, int nz, int ny, int nx, void* stream) {
  if (!kMask && mask != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Jvp3Params P = load_params3(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nq) {
    case 8:
      return launch_tet_tile_nq<Phys, 8, kMask>(P, wv, tv, bv, mask, ov, nz, ny,
                                                nx, s);
    case 4:
      return launch_tet_tile_nq<Phys, 4, kMask>(P, wv, tv, bv, mask, ov, nz, ny,
                                                nx, s);
    case 1:
      return launch_tet_tile_nq<Phys, 1, kMask>(P, wv, tv, bv, mask, ov, nz, ny,
                                                nx, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers, spill bytes, static and dynamic shared bytes and co-resident
// CTAs per SM of U at nq points (common.cuh kernel_info).
template <class Phys, bool kMask, int NQ>
int tet_tile_info_nq(int* out) {
  int bytes = 0;
  const cudaError_t err = tet_tile_smem<Phys, NQ, kMask>(&bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return kernel_info(tet_tile_kernel<Phys, NQ, kMask>, kTetThreads, bytes, out);
}

template <class Phys, bool kMask>
int tet_tile_info(int nq, int* out) {
  switch (nq) {
    case 8: return tet_tile_info_nq<Phys, kMask, 8>(out);
    case 4: return tet_tile_info_nq<Phys, kMask, 4>(out);
    case 1: return tet_tile_info_nq<Phys, kMask, 1>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pfh
