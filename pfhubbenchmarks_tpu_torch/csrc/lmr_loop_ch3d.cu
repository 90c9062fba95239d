// Kernel L, lmr_sweep, for the 3D BM1 Cahn-Hilliard of bench1_3d (kernels I
// and U's physics, phys_ch3d.cuh): the LMR sweep loop of a Kuhn-tet level in
// one launch (lmr_loop.cuh), its A z kernel U's box body, on one vertex grid
// [2, nz+1, ny+1, nx+1]. Replaces
// pfhubbenchmarks_tpu/ops/pallas3d.py:make_pallas_lmr_sweep_loop3d (:182) and
// make_tiled_lmr_sweep3d (:347, whose per-slab dots with alpha outside are
// the slots of phase 3). No Dirichlet rows: the mask argument is null.

#include "lmr_loop.cuh"
#include "phys_ch3d.cuh"

PFH_EXPORT int pfh_lmr_loop_ch3d(const float* params, int nq, float* xv,
                                 float* rv, float* zv, float* av,
                                 const float* pv, const float* wv,
                                 double* partials, int nb, int n_groups,
                                 const int* starts, int n_sweeps, int nz,
                                 int ny, int nx, const float* mask,
                                 int one_cta, int* grid_out, void* stream) {
  return pfh::lmr_loop3<pfh::CH3>(params, nq, xv, rv, zv, av, pv, wv, partials,
                                  nb, n_groups, starts, n_sweeps, nz, ny, nx,
                                  mask, one_cta, grid_out, stream);
}

// Registers, spill bytes, static and dynamic shared bytes and co-resident
// CTAs per SM of L's 3D form at nq points (common.cuh kernel_info).
PFH_EXPORT int pfh_lmr_loop_ch3d_info(int nq, int* out) {
  return pfh::lmr_loop3_info<pfh::CH3>(nq, out);
}
