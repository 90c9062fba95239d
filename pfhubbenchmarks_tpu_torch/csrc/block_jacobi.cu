// Kernel B, block_jacobi_apply: z = P^-1 r with the node-block inverses
// given as F x F planes pv [F, F, ny+1, nx+1] and pm [F, F, ny, nx], f32.
// A 3D state has one vertex grid: pv [F, F, nz+1, ny+1, nx+1], nvert nodes,
// ncell = 0 and null centre pointers (the 3D sweeps of
// pfhubbenchmarks_tpu/ops/pallas3d.py).
//
// Replaces _bj_apply of pfhubbenchmarks_tpu/ops/pallas_vcycle.py (the
// smoother's preconditioning step inside make_fused_vcycle and the LMR
// sweep kernels); the planes come from solve/precond.py:make_block_jacobi,
// built in plain torch. With field groups (a field-split preconditioner,
// whose cross-group planes are exactly zero) output field i sums only over
// the fields j of its own group, as _bj_apply(groups) does: at BM2's six
// fields in groups (c, mu), eta1..eta4 that is 8 of the 36 planes.
//
// Design: one thread per node (vertex or centre) computes all F outputs,
// each summed over the j of its group in increasing order (all of 0..F-1
// without groups). Reads (F^2 + F) floats and writes F floats per node: at
// BM1's 100^2 about 0.5 MB per launch, L2-resident, so the launch is
// latency-bound; it is kept to one launch for both grids. On a gather level
// the sweeps run this body inside kernel L (lmr_loop.cuh); B itself serves
// the launch sequence L is held against.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(pfh::kThreads)
bj_apply_kernel(const float* __restrict__ pv, const float* __restrict__ pm,
                const float* __restrict__ rv, const float* __restrict__ rm,
                float* __restrict__ zv, float* __restrict__ zm, int F,
                const pfh::FieldGroups G, long nvert, long ncell) {
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvert + ncell) return;
  const bool on_v = idx < nvert;
  const long node = on_v ? idx : idx - nvert;
  const long n = on_v ? nvert : ncell;
  const float* P = on_v ? pv : pm;
  const float* r = on_v ? rv : rm;
  float* z = on_v ? zv : zm;
  for (int i = 0; i < F; ++i) {
    const int g = pfh::group_of(G, i);
    float acc = 0.f;
    for (int j = G.start[g]; j < G.start[g + 1]; ++j)
      acc += __ldg(P + (static_cast<long>(i) * F + j) * n + node) * __ldg(r + j * n + node);
    z[i * n + node] = acc;
  }
}

}  // namespace

// starts: n_groups + 1 host ints (pfh::make_groups), or null for no groups.
PFH_EXPORT int pfh_block_jacobi_apply(const float* pv, const float* pm,
                                      const float* rv, const float* rm,
                                      float* zv, float* zm, int F, long nvert,
                                      long ncell, int n_groups,
                                      const int* starts, void* stream) {
  pfh::FieldGroups G;
  if (!pfh::make_groups(F, n_groups, starts, &G))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = pfh::blocks_for(nvert + ncell);
  bj_apply_kernel<<<blocks, pfh::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pv, pm, rv, rm, zv, zm, F, G, nvert, ncell);
  return static_cast<int>(cudaGetLastError());
}
