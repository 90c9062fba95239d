// Kernels T10, T12 and TS at BM2's physics with 4 order parameters (fields
// c, mu, eta_1..eta_4): the tile bodies of fem_tile.cuh with phys_chac.cuh's
// tangents, the coupled operator at ffc3 (4 points: the outer J.v) and the
// field-split one at dunavant1 (1 point: the multigrid levels), as BM2's
// grids use them. Replaces pfhubbenchmarks_tpu/ops/pallas_tiled.py:
// make_tiled_jvp and ops/pallas_tiled_grid.py:make_grid_tiled_jvp and
// make_grid_tiled_lmr_sweep at BM2's 6-field shape; see fem_tile.cuh for
// the design and what bounds it. A tile stages 11 planes (c, the 4 etas
// and 6 tangent planes) and accumulates 6: 16 KB of shared memory.

#include "fem_tile.cuh"
#include "phys_chac.cuh"

// ne: the number of Allen-Cahn fields (4); split: 0 for the coupled
// operator (at nq 4), 1 for the field-split one (at nq 1).
PFH_EXPORT int pfh_chac_tile(int form, const float* params, int nq, int ne,
                             int split, const float* wv, const float* wm,
                             const float* tv, const float* tm, const float* pv,
                             const float* pm, const float* bv, const float* bm,
                             const float* mask, float* ov, float* om, float* zv,
                             float* zm, float* seam, int n_groups,
                             const int* starts, int ny, int nx, void* stream) {
  const pfh::TileIO io{wv, wm, tv, tm, pv, pm, bv, bm, mask, ov, om, zv, zm, seam};
  if (ne == 4 && split == 0 && nq == 4)
    return pfh::launch_fem_tile<pfh::CHAC<4, false>, 4>(
        form, params, io, n_groups, starts, ny, nx, stream);
  if (ne == 4 && split != 0 && nq == 1)
    return pfh::launch_fem_tile<pfh::CHAC<4, true>, 1>(
        form, params, io, n_groups, starts, ny, nx, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
