// Kernel L, lmr_sweep, for BM3's Allen-Cahn + heat (kernel G's physics,
// phys_ach.cuh): the LMR sweep loop of a gather level in one launch
// (lmr_loop.cuh). Replaces, at this physics, the sweep kernels that
// lmr_loop.cuh names (TPU rows 3, 4 and 11) and the sweeps of the level
// steps (rows 6 and 9).

#include "lmr_loop.cuh"
#include "phys_ach.cuh"

PFH_EXPORT int pfh_lmr_loop_ach(
    const float* params, int nq, float* xv, float* xm, float* rv, float* rm,
    float* zv, float* zm, float* av, float* am, const float* pv,
    const float* pm, const float* wv, const float* wm, const float* mask,
    double* partials, int nb, int n_groups, const int* starts, int n_sweeps,
    int ny, int nx, int one_cta, int* grid_out, void* stream) {
  return pfh::lmr_loop2<pfh::ACH>(params, nq, xv, xm, rv, rm, zv, zm, av, am,
                                 pv, pm, wv, wm, mask, partials, nb, n_groups,
                                 starts, n_sweeps, ny, nx, one_cta,
                                 grid_out, stream);
}
