// Kernel U, ch3d_tile: J.v of BM1's mixed Cahn-Hilliard weak form on the 3D
// Kuhn-tet grid (bench1_3d) over shared-memory tet boxes, (w, dt, v) -> Jv,
// f32; fields (c, mu) on one vertex grid [2, nz+1, ny+1, nx+1]. The body is
// fem_tet_tile.cuh's (each tet of a box evaluated once), the pointwise
// tangent phys_ch3d.cuh's, the arguments kernel I's (ch3d_jvp.cu) with the
// Dirichlet mask after b, which this instantiation (no kMask) takes null.
//
// Replaces pfhubbenchmarks_tpu/ops/pallas3d.py:make_tiled_jvp3d (:294, the
// z-slab J.v: the outer Krylov matvec at ffc3 and every level's residual J.v
// at keast2) and make_pallas_jvp3d (:149); its body is also the A z of the 3D
// sweep loop, kernel L (lmr_loop_ch3d.cu). Kernel I, the gather form, stays
// built as its comparison.
//
// What bounds it on the H100: operations (fem_tet_tile.cuh): at 50^3 one
// launch evaluates 1.482 x 750,000 tets once each at 4 (keast2) or 8 (ffc3)
// points, from ~1.6 MB of planes staged through shared memory.

#include "fem_tet_tile.cuh"
#include "phys_ch3d.cuh"

PFH_EXPORT int pfh_ch3d_tile(const float* params, int nq, const float* wv,
                             const float* tv, const float* bv,
                             const float* mask, float* ov, int nz, int ny,
                             int nx, void* stream) {
  return pfh::launch_tet_tile<pfh::CH3, false>(params, nq, wv, tv, bv, mask, ov,
                                               nz, ny, nx, stream);
}

// Registers, spill bytes, static and dynamic shared bytes and co-resident
// CTAs per SM of U at nq points (common.cuh kernel_info).
PFH_EXPORT int pfh_ch3d_tile_info(int nq, int* out) {
  return pfh::tet_tile_info<pfh::CH3, false>(nq, out);
}
