// Kernel L, lmr_sweep, at the anisotropic BM3's physics (phys_acha.cuh): the
// LMR sweep loop of a gather level in one launch (lmr_loop.cuh). It runs the
// chains' launch sequences (ops/vcycle_chain.py .sequence, their
// comparison) and the coarsest level's sweeps where that is not the dense
// inverse; replaces, at this physics, the sweep kernels that lmr_loop.cuh
// names (TPU rows 3, 4 and 11).

#include "lmr_loop.cuh"
#include "phys_acha.cuh"

PFH_EXPORT int pfh_lmr_loop_acha(
    const float* params, int nq, float* xv, float* xm, float* rv, float* rm,
    float* zv, float* zm, float* av, float* am, const float* pv,
    const float* pm, const float* wv, const float* wm, const float* mask,
    double* partials, int nb, int n_groups, const int* starts, int n_sweeps,
    int ny, int nx, int one_cta, int* grid_out, void* stream) {
  return pfh::lmr_loop2<pfh::ACHA>(params, nq, xv, xm, rv, rm, zv, zm, av, am,
                                  pv, pm, wv, wm, mask, partials, nb, n_groups,
                                  starts, n_sweeps, ny, nx, one_cta, grid_out,
                                  stream);
}
