// Kernels T and TS: the crossed-P1 J.v and the LMR sweep's z, A z over
// shared-memory tiles, templated on the physics (phys_*.cuh).
//
// Replaces the row-block kernels of the JAX package's tiled configuration:
//   T10 (FORM kRecompute) pfhubbenchmarks_tpu/ops/pallas_tiled.py:
//       make_tiled_jvp: each block re-evaluates the halo cells its owned
//       nodes need and writes only what it owns, in one launch;
//   T12 (FORM kSeam) ops/pallas_tiled_grid.py:make_grid_tiled_jvp: each
//       block evaluates only its own cells, writes its interior nodes and
//       emits partial sums on its seams, which a fold then adds;
//   TS  (FORM kSweep) ops/pallas_tiled_grid.py:make_grid_tiled_lmr_sweep:
//       z = P^-1 r per node (block-Jacobi, in-group planes only), then A z
//       in the seam form. alpha and the axpys come outside (kernel C), as
//       the JAX package forms alpha outside its kernel from the folded A z.
// Computes out = J(w, dt) v or b - J(w, dt) v (T10, T12) or (z, A z) (TS),
// f32, layout as fem_params.cuh. T10 also takes the Dirichlet mask of
// fem_jvp.cuh (a masked row is v, or b - v); T12 and TS take none: the
// levels routed to them have no Dirichlet rows, as in the JAX package.
//
// Design. The TPU blocks are whole row slabs (grid=(nb,), 14 at 350^2); on
// the H100 a CTA takes a box of kTileCY x kTileCX cells, tiled over both
// axes (968 CTAs at 350^2). It stages the box's state and tangent (or z)
// operands, vertex box (kTileCY+1) x (kTileCX+1) and centre box, in dynamic
// shared memory; each thread evaluates ONE cell, every triangle's
// quadrature-point tangent once (the gather kernels evaluate each triangle
// three times, once per node), and keeps the 5 slot sums of its cell in
// registers. The slot sums go into shared-memory vertex accumulators in
// four passes (SW, SE, NE, NW) separated by barriers: in a pass each vertex
// gets at most one cell's sum, so every vertex is summed in one fixed order
// with no atomics, and two calls give the same bits. A centre is its own
// cell's sum. The box of T10 carries a halo row below and a halo column to
// the left, so a tile owns (kTileCY-1) x (kTileCX-1) cells and every owned
// vertex sees all four of its cells; T12 and TS own the whole box, and the
// top row and right column of the vertex box are partial sums for the next
// tiles: the fold (tile_fold_kernel) adds them into the bottom row and left
// column of those tiles, x-seams, y-seams and corners once each in a fixed
// order, and applies b.
//
// What bounds it on the H100: at 350^2 and F = 2, one launch reads ~3.9 MB
// and writes ~2 MB (bytes ~1.8 us at 3.35 TB/s), and its f32 operations
// bound it at ~2.6 us (ffc3); a tile stages 281 nodes per plane for 128
// cells, so the staging reads ~2.2x the plane bytes, from L2.
#pragma once

#include "fem_params.cuh"

namespace pfh {

constexpr int kTileCY = 8;                       // cell rows of a box
constexpr int kTileCX = 16;                      // cell columns of a box
constexpr int kTileVY = kTileCY + 1;             // vertex rows of a box
constexpr int kTileVX = kTileCX + 1;             // vertex columns of a box
constexpr int kTileCells = kTileCY * kTileCX;    // 128, one thread per cell
constexpr int kTileVerts = kTileVY * kTileVX;    // 153
constexpr int kTileNodes = kTileVerts + kTileCells;

enum TileForm : int { kRecompute = 0, kSeam = 1, kSweep = 2 };

// the halo of a form's box, and the cells a tile owns along y and x
__host__ __device__ constexpr int tile_halo(int form) {
  return form == kRecompute ? 1 : 0;
}
__host__ __device__ constexpr int tile_ty(int form) {
  return kTileCY - tile_halo(form);
}
__host__ __device__ constexpr int tile_tx(int form) {
  return kTileCX - tile_halo(form);
}

// Seam partials of the seam forms: per field and tile, the top row of the
// vertex box (kTileVX values), then per field and tile its right column
// (kTileVY values, the corner in both).
inline long tile_seam_floats(int F, int ny, int nx) {
  const long tiles = static_cast<long>((ny + tile_ty(kSeam) - 1) / tile_ty(kSeam))
                     * ((nx + tile_tx(kSeam) - 1) / tile_tx(kSeam));
  return F * tiles * (kTileVX + kTileVY);
}

// The operands of one launch. tv/tm: the J.v direction v (T10, T12) or the
// residual r (TS); pv/pm: the block-Jacobi planes (TS); bv/bm: b of the
// b - J v form or null (T10, T12); mask: T10's Dirichlet mask or null;
// ov/om: the result (A z for TS); zv/zm: TS's z; seam: the seam partials
// (T12, TS; tile_seam_floats floats).
struct TileIO {
  const float *wv, *wm, *tv, *tm, *pv, *pm, *bv, *bm, *mask;
  float *ov, *om, *zv, *zm, *seam;
};

// The slot sums acc[slot][field] of box cell (ci, cj) from the staged
// planes: sw NS state planes, sd NF tangent planes, each kTileNodes floats
// (the vertex box, then the centre box).
template <class Phys, int NQ>
__device__ __forceinline__ void tile_cell(const JvpParams& P,
                                          const float* __restrict__ sw,
                                          const float* __restrict__ sd,
                                          int ci, int cj,
                                          float (&acc)[5][Phys::NF]) {
  constexpr int NF = Phys::NF;
  constexpr int NS = Phys::NS;
  const int vsw = ci * kTileVX + cj;
  const int at[5] = {vsw, vsw + 1, vsw + kTileVX + 1, vsw + kTileVX,
                     kTileVerts + ci * kTileCX + cj};
  float wc[NS][5], d[NF][5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
#pragma unroll
    for (int f = 0; f < NS; ++f) wc[f][s] = sw[f * kTileNodes + at[s]];
#pragma unroll
    for (int f = 0; f < NF; ++f) d[f][s] = sd[f * kTileNodes + at[s]];
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
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
      Phys::tangent(P, u, dq, gx, gy, src, fx, fy);
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        if (!slot_in_tri(t, s)) continue;
#pragma unroll
        for (int f = 0; f < NF; ++f)
          acc[s][f] += P.WB[t][q][s] * src[f] + P.WGx[t][q][s] * fx[f]
                       + P.WGy[t][q][s] * fy[f];
      }
    }
  }
}

template <class Phys, int NQ, int FORM>
__global__ void __launch_bounds__(kTileCells)
fem_tile_kernel(const JvpParams P, const TileIO io, const FieldGroups G,
                int ny, int nx) {
  constexpr int NF = Phys::NF;
  constexpr int NS = Phys::NS;
  constexpr int H = tile_halo(FORM);
  extern __shared__ float smem[];
  float* sw = smem;                         // NS planes of kTileNodes
  float* sd = sw + NS * kTileNodes;         // NF planes of kTileNodes
  float* sacc = sd + NF * kTileNodes;       // NF planes of kTileVerts
  const int nvx = nx + 1;
  const long nvert = static_cast<long>(ny + 1) * nvx;
  const long ncell = static_cast<long>(ny) * nx;
  const int cy0 = blockIdx.y * tile_ty(FORM) - H;  // the box's first cell
  const int cx0 = blockIdx.x * tile_tx(FORM) - H;

  // stage the box: vertices, then centres; zero the accumulators
  for (int k = threadIdx.x; k < kTileNodes; k += blockDim.x) {
    const bool vert = k < kTileVerts;
    const int kk = vert ? k : k - kTileVerts;
    const int gy = cy0 + (vert ? kk / kTileVX : kk / kTileCX);
    const int gx = cx0 + (vert ? kk % kTileVX : kk % kTileCX);
    const bool in = gy >= 0 && gx >= 0 && (vert ? gy <= ny && gx <= nx
                                                : gy < ny && gx < nx);
    const long n = vert ? nvert : ncell;
    const long node = in ? (vert ? static_cast<long>(gy) * nvx + gx
                                 : static_cast<long>(gy) * nx + gx) : 0;
    const float* w = vert ? io.wv : io.wm;
    const float* t = vert ? io.tv : io.tm;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      sw[s * kTileNodes + k] = in ? __ldg(w + Phys::state_field(s) * n + node) : 0.f;
    if (FORM == kSweep) {
      // z = P^-1 r: output i sums the j of its group in increasing order,
      // as kernel B (block_jacobi.cu) does
      const float* pl = vert ? io.pv : io.pm;
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int g = group_of(G, i);
        float z = 0.f;
        if (in)
          for (int j = G.start[g]; j < G.start[g + 1]; ++j)
            z += __ldg(pl + (static_cast<long>(i) * NF + j) * n + node)
                 * __ldg(t + j * n + node);
        sd[i * kTileNodes + k] = z;
      }
    } else {
#pragma unroll
      for (int f = 0; f < NF; ++f)
        sd[f * kTileNodes + k] = in ? __ldg(t + f * n + node) : 0.f;
    }
    if (vert) {
#pragma unroll
      for (int f = 0; f < NF; ++f) sacc[f * kTileVerts + k] = 0.f;
    }
  }
  __syncthreads();

  // one cell per thread: its slot sums, then four passes into the vertices
  const int ci = threadIdx.x / kTileCX, cj = threadIdx.x % kTileCX;
  const int gy = cy0 + ci, gx = cx0 + cj;
  const bool cell_in = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
  float acc[5][NF];
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int f = 0; f < NF; ++f) acc[s][f] = 0.f;
  if (cell_in) tile_cell<Phys, NQ>(P, sw, sd, ci, cj, acc);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int v = (ci + (s >= 2)) * kTileVX + cj + (s == 1 || s == 2);
    if (cell_in) {
#pragma unroll
      for (int f = 0; f < NF; ++f) sacc[f * kTileVerts + v] += acc[s][f];
    }
    __syncthreads();
  }

  // the owned centre
  if (cell_in && ci >= H && cj >= H) {
    const long c = static_cast<long>(gy) * nx + gx;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const long o = f * ncell + c;
      io.om[o] = io.bm != nullptr ? __ldg(io.bm + o) - acc[4][f] : acc[4][f];
      if (FORM == kSweep)
        io.zm[o] = sd[f * kTileNodes + kTileVerts + ci * kTileCX + cj];
    }
  }

  // the owned vertices, and the seam partials of the seam forms
  const int nby = gridDim.y, nbx = gridDim.x;
  const long tile = static_cast<long>(blockIdx.y) * nbx + blockIdx.x;
  float* seam_t = io.seam;
  float* seam_r = io.seam + static_cast<long>(NF) * nby * nbx * kTileVX;
  for (int k = threadIdx.x; k < kTileVerts; k += blockDim.x) {
    const int i = k / kTileVX, j = k % kTileVX;
    const int vy = cy0 + i, vx = cx0 + j;
    if (vy < 0 || vx < 0 || vy > ny || vx > nx) continue;
    const bool owned = i >= H && j >= H && (i < kTileCY || vy == ny)
                       && (j < kTileCX || vx == nx);
    if (owned) {
      // a seam form's bottom row and left column wait for the fold
      const bool partial = FORM != kRecompute && ((i == 0 && vy > 0)
                                                  || (j == 0 && vx > 0));
      const long node = static_cast<long>(vy) * nvx + vx;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const long o = f * nvert + node;
        float val = sacc[f * kTileVerts + k];
        if (FORM == kRecompute && io.mask != nullptr && __ldg(io.mask + o) != 0.f)
          val = __ldg(io.tv + o);
        if (io.bv != nullptr && !partial) val = __ldg(io.bv + o) - val;
        io.ov[o] = val;
        if (FORM == kSweep) io.zv[o] = sd[f * kTileNodes + k];
      }
    } else if (FORM != kRecompute) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const float val = sacc[f * kTileVerts + k];
        if (i == kTileCY && vy < ny)
          seam_t[(f * nby * nbx + tile) * kTileVX + j] = val;
        if (j == kTileCX && vx < nx)
          seam_r[(f * nby * nbx + tile) * kTileVY + i] = val;
      }
    }
  }
}

namespace {

// The fold of the seam forms: one thread per vertex on a tile seam adds the
// partials of the tiles below, to the left and below-left, in that order,
// to the tile's own sum, then applies b (bv null: none).
__global__ void __launch_bounds__(kThreads)
tile_fold_kernel(const float* __restrict__ seam, const float* __restrict__ bv,
                 float* __restrict__ ov, int F, int ny, int nx, int nby,
                 int nbx) {
  constexpr int TY = tile_ty(kSeam), TX = tile_tx(kSeam);
  const long nrow = static_cast<long>(nby - 1) * (nx + 1);  // x-seam vertices
  const long ncol = static_cast<long>(nbx - 1) * (ny + 1);  // y-seam vertices
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nrow + ncol) return;
  int y, x;
  if (idx < nrow) {
    y = static_cast<int>(idx / (nx + 1) + 1) * TY;
    x = static_cast<int>(idx % (nx + 1));
  } else {
    const long j = idx - nrow;
    x = static_cast<int>(j / (ny + 1) + 1) * TX;
    y = static_cast<int>(j % (ny + 1));
    if (y % TY == 0 && y > 0 && y < ny) return;  // an x-seam vertex: done above
  }
  const int by = min(y / TY, nby - 1), bx = min(x / TX, nbx - 1);
  const int ly = y - by * TY, lx = x - bx * TX;
  const long nt = static_cast<long>(nby) * nbx;
  const float* seam_t = seam;
  const float* seam_r = seam + F * nt * kTileVX;
  const long nvert = static_cast<long>(ny + 1) * (nx + 1);
  for (int f = 0; f < F; ++f) {
    const long o = f * nvert + static_cast<long>(y) * (nx + 1) + x;
    float tot = ov[o];
    if (ly == 0 && by > 0)
      tot += seam_t[(f * nt + (by - 1) * nbx + bx) * kTileVX + lx];
    if (lx == 0 && bx > 0)
      tot += seam_r[(f * nt + by * nbx + bx - 1) * kTileVY + ly];
    if (ly == 0 && lx == 0 && by > 0 && bx > 0)
      tot += seam_t[(f * nt + (by - 1) * nbx + bx - 1) * kTileVX + TX];
    ov[o] = bv != nullptr ? __ldg(bv + o) - tot : tot;
  }
}

}  // namespace

// The dynamic shared bytes of a tile: the staged state and tangent planes
// and the vertex accumulators.
template <class Phys>
constexpr size_t tile_smem_bytes() {
  return sizeof(float)
         * ((Phys::NS + Phys::NF) * kTileNodes + Phys::NF * kTileVerts);
}

template <class Phys, int NQ, int FORM>
int launch_tile_form(const JvpParams& P, const TileIO& io, const FieldGroups& G,
                     int ny, int nx, cudaStream_t s) {
  constexpr int NF = Phys::NF;
  const int nby = (ny + tile_ty(FORM) - 1) / tile_ty(FORM);
  const int nbx = (nx + tile_tx(FORM) - 1) / tile_tx(FORM);
  constexpr size_t bytes = tile_smem_bytes<Phys>();
  // past 48 KB a launch would have to raise the limit with
  // cudaFuncSetAttribute(MaxDynamicSharedMemorySize); BM2's 6 fields take 16 KB
  static_assert(bytes <= 48 * 1024, "the tile's shared memory passes 48 KB");
  fem_tile_kernel<Phys, NQ, FORM><<<dim3(nbx, nby), kTileCells, bytes, s>>>(
      P, io, G, ny, nx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || FORM == kRecompute) return static_cast<int>(err);
  const long n = static_cast<long>(nby - 1) * (nx + 1)
                 + static_cast<long>(nbx - 1) * (ny + 1);
  if (n > 0)
    tile_fold_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        io.seam, FORM == kSeam ? io.bv : nullptr, io.ov, NF, ny, nx, nby, nbx);
  return static_cast<int>(cudaGetLastError());
}

// Host launcher of one physics at one rule. form: a TileForm; params: the
// JvpParams block (load_params); starts: TS's n_groups + 1 field-group
// starts (make_groups) or null. Refuses what a form does not take.
template <class Phys, int NQ>
int launch_fem_tile(int form, const float* params, const TileIO& io,
                    int n_groups, const int* starts, int ny, int nx,
                    void* stream) {
  FieldGroups G;
  if (!make_groups(Phys::NF, n_groups, starts, &G))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool seam_form = form == kSeam || form == kSweep;
  if ((seam_form && (io.mask != nullptr || io.seam == nullptr))
      || ((form == kSweep) != (io.pv != nullptr && io.zv != nullptr))
      || (form == kSweep && (io.bv != nullptr || io.bm != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const JvpParams P = load_params(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kRecompute:
      return launch_tile_form<Phys, NQ, kRecompute>(P, io, G, ny, nx, s);
    case kSeam:
      return launch_tile_form<Phys, NQ, kSeam>(P, io, G, ny, nx, s);
    case kSweep:
      return launch_tile_form<Phys, NQ, kSweep>(P, io, G, ny, nx, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pfh
