// Kernels T10, T12 and TS at BM1's physics (fields c, mu): the tile bodies
// of fem_tile.cuh with phys_ch.cuh's tangent, at the rules of BM1's grids
// (ffc3, 4 points: the outer J.v; dunavant2, 3 points: the multigrid
// levels). Replaces pfhubbenchmarks_tpu/ops/pallas_tiled.py:make_tiled_jvp
// and ops/pallas_tiled_grid.py:make_grid_tiled_jvp and
// make_grid_tiled_lmr_sweep; see fem_tile.cuh for the design and what
// bounds it.

#include "fem_tile.cuh"
#include "phys_ch.cuh"

PFH_EXPORT int pfh_tile_seam_floats(int F, int ny, int nx) {
  return static_cast<int>(pfh::tile_seam_floats(F, ny, nx));
}

PFH_EXPORT int pfh_ch_tile(int form, const float* params, int nq,
                           const float* wv, const float* wm, const float* tv,
                           const float* tm, const float* pv, const float* pm,
                           const float* bv, const float* bm, const float* mask,
                           float* ov, float* om, float* zv, float* zm,
                           float* seam, int n_groups, const int* starts,
                           int ny, int nx, void* stream) {
  const pfh::TileIO io{wv, wm, tv, tm, pv, pm, bv, bm, mask, ov, om, zv, zm, seam};
  if (nq == 4)
    return pfh::launch_fem_tile<pfh::CH, 4>(form, params, io, n_groups, starts,
                                            ny, nx, stream);
  if (nq == 3)
    return pfh::launch_fem_tile<pfh::CH, 3>(form, params, io, n_groups, starts,
                                            ny, nx, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
