// Kernels T10, T12 and TS at BM3's physics (fields U, phi, no anisotropy):
// the tile bodies of fem_tile.cuh with phys_ach.cuh's tangent, at the rules
// of BM3's grids (ffc3, 4 points: the outer J.v; dunavant2, 3 points: the
// multigrid levels). Replaces pfhubbenchmarks_tpu/ops/pallas_tiled.py:
// make_tiled_jvp and ops/pallas_tiled_grid.py:make_grid_tiled_jvp and
// make_grid_tiled_lmr_sweep at the 350^2 shape they were built for; see
// fem_tile.cuh for the design and what bounds it.

#include "fem_tile.cuh"
#include "phys_ach.cuh"

PFH_EXPORT int pfh_ach_tile(int form, const float* params, int nq,
                            const float* wv, const float* wm, const float* tv,
                            const float* tm, const float* pv, const float* pm,
                            const float* bv, const float* bm, const float* mask,
                            float* ov, float* om, float* zv, float* zm,
                            float* seam, int n_groups, const int* starts,
                            int ny, int nx, void* stream) {
  const pfh::TileIO io{wv, wm, tv, tm, pv, pm, bv, bm, mask, ov, om, zv, zm, seam};
  if (nq == 4)
    return pfh::launch_fem_tile<pfh::ACH, 4>(form, params, io, n_groups, starts,
                                             ny, nx, stream);
  if (nq == 3)
    return pfh::launch_fem_tile<pfh::ACH, 3>(form, params, io, n_groups, starts,
                                             ny, nx, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of the
// tile kernel of `form` at nq points (common.cuh kernel_info): the T12
// question of tools/torch_tile_probe.py. The fold is a second, small kernel.
PFH_EXPORT int pfh_ach_tile_info(int form, int nq, int* out) {
  constexpr int bytes = static_cast<int>(pfh::tile_smem_bytes<pfh::ACH>());
  using pfh::ACH;
  if (form == pfh::kSeam && nq == 3)
    return pfh::kernel_info(pfh::fem_tile_kernel<ACH, 3, pfh::kSeam>,
                            pfh::kTileCells, bytes, out);
  if (form == pfh::kSeam && nq == 4)
    return pfh::kernel_info(pfh::fem_tile_kernel<ACH, 4, pfh::kSeam>,
                            pfh::kTileCells, bytes, out);
  if (form == pfh::kRecompute && nq == 3)
    return pfh::kernel_info(pfh::fem_tile_kernel<ACH, 3, pfh::kRecompute>,
                            pfh::kTileCells, bytes, out);
  if (form == pfh::kRecompute && nq == 4)
    return pfh::kernel_info(pfh::fem_tile_kernel<ACH, 4, pfh::kRecompute>,
                            pfh::kTileCells, bytes, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
