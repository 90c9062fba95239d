// Kernel U at BM6's physics, chp3d_tile: J.v of bench6_3d's Cahn-Hilliard +
// Poisson weak form on the 3D Kuhn-tet grid over shared-memory tet boxes,
// (w, dt, v, mask) -> Jv, f32; fields (c, mu, phi) on one vertex grid
// [3, nz+1, ny+1, nx+1]. The body is fem_tet_tile.cuh's (each tet of a box
// evaluated once), with kMask: a Dirichlet row of phi (the x0 and x1 faces,
// mask != 0) stores v (or b - v). The pointwise tangent is phys_chp3d.cuh's.
//
// Replaces no TPU kernel: the JAX package runs bench6_3d's J.v on XLA
// (its outer J.v factory returns None with Dirichlet faces,
// pfhubbenchmarks_tpu/benchmarks/bench1_3d.py:114-120, and its 3D cycle
// skips the Pallas kernels on levels with BC rows, solve/gmg3d.py:93). In
// the port every J.v on the card is a hand-written kernel: this one is
// bench6_3d's outer Krylov J.v at ffc3 and every level's b - A x; its body
// is also the A z of kernel L's 3D sweeps at BM6 (lmr_loop_chp3d.cu).
//
// What bounds it on the H100: operations (fem_tet_tile.cuh): at 50^3 one
// launch evaluates 1.482 x 750,000 tets once each at 8 points (bench6_3d
// sets no precond_rule: ffc3 on every level), from ~2.1 MB of planes (the
// state's c and three tangent planes) staged through shared memory.

#include "fem_tet_tile.cuh"
#include "phys_chp3d.cuh"

PFH_EXPORT int pfh_chp3d_tile(const float* params, int nq, const float* wv,
                              const float* tv, const float* bv,
                              const float* mask, float* ov, int nz, int ny,
                              int nx, void* stream) {
  return pfh::launch_tet_tile<pfh::CHP3, true>(params, nq, wv, tv, bv, mask, ov,
                                               nz, ny, nx, stream);
}

// Registers, spill bytes, static and dynamic shared bytes and co-resident
// CTAs per SM of U at BM6's physics at nq points (common.cuh kernel_info).
PFH_EXPORT int pfh_chp3d_tile_info(int nq, int* out) {
  return pfh::tet_tile_info<pfh::CHP3, true>(nq, out);
}
