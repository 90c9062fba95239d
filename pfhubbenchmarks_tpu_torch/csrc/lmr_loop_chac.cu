// Kernel L, lmr_sweep, for BM2's Cahn-Hilliard + NE Allen-Cahn (kernel F's
// physics): the LMR sweep loop of a gather level in one launch
// (lmr_loop.cuh), NE in {1, 2, 4}, the coupled or the field-split operator
// (phys_chac.cuh), with field groups and one step length per group. Replaces,
// at this physics, the sweep kernels that lmr_loop.cuh names (TPU rows 3, 4
// and 11).

#include "lmr_loop.cuh"
#include "phys_chac.cuh"

namespace {

template <int NE>
int launch_ne(bool split, const float* params, int nq, float* xv, float* xm,
              float* rv, float* rm, float* zv, float* zm, float* av, float* am,
              const float* pv, const float* pm, const float* wv,
              const float* wm, const float* mask, double* partials, int nb,
              int n_groups, const int* starts, int n_sweeps, int ny, int nx,
              int one_cta, int* grid_out, void* stream) {
  return split ? pfh::lmr_loop2<pfh::CHAC<NE, true>>(
                     params, nq, xv, xm, rv, rm, zv, zm, av, am, pv, pm, wv, wm,
                     mask, partials, nb, n_groups, starts, n_sweeps, ny, nx,
                     one_cta, grid_out, stream)
               : pfh::lmr_loop2<pfh::CHAC<NE, false>>(
                     params, nq, xv, xm, rv, rm, zv, zm, av, am, pv, pm, wv, wm,
                     mask, partials, nb, n_groups, starts, n_sweeps, ny, nx,
                     one_cta, grid_out, stream);
}

}  // namespace

// ne: the number of Allen-Cahn fields (1, 2 or 4); split: 0 for the coupled
// operator, 1 for the field-split one.
PFH_EXPORT int pfh_lmr_loop_chac(
    const float* params, int nq, int ne, int split, float* xv, float* xm,
    float* rv, float* rm, float* zv, float* zm, float* av, float* am,
    const float* pv, const float* pm, const float* wv, const float* wm,
    const float* mask, double* partials, int nb, int n_groups,
    const int* starts, int n_sweeps, int ny, int nx, int one_cta,
    int* grid_out, void* stream) {
  switch (ne) {
    case 1:
      return launch_ne<1>(split != 0, params, nq, xv, xm, rv, rm, zv, zm, av,
                          am, pv, pm, wv, wm, mask, partials, nb, n_groups,
                          starts, n_sweeps, ny, nx, one_cta, grid_out,
                          stream);
    case 2:
      return launch_ne<2>(split != 0, params, nq, xv, xm, rv, rm, zv, zm, av,
                          am, pv, pm, wv, wm, mask, partials, nb, n_groups,
                          starts, n_sweeps, ny, nx, one_cta, grid_out,
                          stream);
    case 4:
      return launch_ne<4>(split != 0, params, nq, xv, xm, rv, rm, zv, zm, av,
                          am, pv, pm, wv, wm, mask, partials, nb, n_groups,
                          starts, n_sweeps, ny, nx, one_cta, grid_out,
                          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
