// Kernel L at BM6's physics in 3D, lmr_loop_chp3d: the LMR sweep loop of a
// Kuhn-tet level of bench6_3d in one launch (lmr_loop.cuh), its A z kernel
// U's box body at CHP3 (phys_chp3d.cuh) with the Dirichlet mask (kMask: a
// row of phi on the x0 and x1 faces gives z), on one vertex grid
// [3, nz+1, ny+1, nx+1], at 1, 4 and 8 points (bench6_3d runs ffc3, 8, on
// every level).
//
// Replaces no TPU kernel: the JAX package's 3D cycle skips its Pallas sweep
// kernels on every level with BC rows (pfhubbenchmarks_tpu/solve/gmg3d.py:93)
// and sweeps bench6_3d's levels on XLA. In the port every level's sweeps on
// the card are one launch of L. What bounds it on the H100: the sweeps'
// operations (n times U's at 8 points) at 50^3 and 25^3; its working set
// (state, P^-1, x, r, z, A z: ~14 floats per node) is L2-resident.

#include "lmr_loop.cuh"
#include "phys_chp3d.cuh"

PFH_EXPORT int pfh_lmr_loop_chp3d(const float* params, int nq, float* xv,
                                  float* rv, float* zv, float* av,
                                  const float* pv, const float* wv,
                                  double* partials, int nb, int n_groups,
                                  const int* starts, int n_sweeps, int nz,
                                  int ny, int nx, const float* mask,
                                  int one_cta, int* grid_out, void* stream) {
  return pfh::lmr_loop3<pfh::CHP3, true>(params, nq, xv, rv, zv, av, pv, wv,
                                         partials, nb, n_groups, starts,
                                         n_sweeps, nz, ny, nx, mask, one_cta,
                                         grid_out, stream);
}

// Registers, spill bytes, static and dynamic shared bytes and co-resident
// CTAs per SM of L's 3D form at BM6's physics at nq points.
PFH_EXPORT int pfh_lmr_loop_chp3d_info(int nq, int* out) {
  return pfh::lmr_loop3_info<pfh::CHP3, true>(nq, out);
}
