// Kernel L, lmr_sweep, for BM6's Cahn-Hilliard + Poisson (kernel E's
// physics, phys_chp.cuh), with the Dirichlet rows of phi as a mask: the LMR
// sweep loop of a gather level in one launch (lmr_loop.cuh). Replaces, at
// this physics, the sweep kernels that lmr_loop.cuh names (TPU rows 3, 4 and
// 11) and the masked sweeps of the chains (rows 7 and 8).

#include "lmr_loop.cuh"
#include "phys_chp.cuh"

PFH_EXPORT int pfh_lmr_loop_chp(
    const float* params, int nq, float* xv, float* xm, float* rv, float* rm,
    float* zv, float* zm, float* av, float* am, const float* pv,
    const float* pm, const float* wv, const float* wm, const float* mask,
    double* partials, int nb, int n_groups, const int* starts, int n_sweeps,
    int ny, int nx, int one_cta, int* grid_out, void* stream) {
  return pfh::lmr_loop2<pfh::CHP>(params, nq, xv, xm, rv, rm, zv, zm, av, am,
                                 pv, pm, wv, wm, mask, partials, nb, n_groups,
                                 starts, n_sweeps, ny, nx, one_cta,
                                 grid_out, stream);
}
