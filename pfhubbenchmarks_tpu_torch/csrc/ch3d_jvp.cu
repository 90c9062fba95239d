// Kernel I, ch3d_jvp: J.v of BM1's mixed Cahn-Hilliard weak form on the 3D
// Kuhn-tet grid (bench1_3d), (w, dt, v) -> Jv, f32; fields (c, mu) on one
// vertex grid [2, nz+1, ny+1, nx+1].
//
// The gather form of pfhubbenchmarks_tpu/ops/pallas3d.py:make_pallas_jvp3d
// (the whole-array 3D J.v) and make_tiled_jvp3d (the z-slab J.v). Kernel U
// (ch3d_tile.cu, tet boxes) took its place on every path, the outer J.v,
// the level J.v and, as its body, kernel L's 3D A z; I stays built as U's
// comparison (ops/fem_jvp3d.py jv.gather, chip_smoke.py phase 11). The
// gather body is fem_jvp3d.cuh's; this file supplies the 3D form of BM1's
// pointwise tangent (the mirror of benchmarks/bench1.py:terms_tangent, which
// bench1_3d reuses: its fluxes are written per axis). It does not depend on
// the previous time level, so w0 is not an argument.
//
// What bounds it on the H100: at bench1_3d's 50^3 (132,651 nodes, ~1,040
// blocks of 128) one ffc3 launch reads ~1.6 MB and writes ~1.1 MB, L2-resident,
// while each node recomputes the tangents of its up to 24 tets at 8 points
// (each tet is evaluated once per vertex, 4 times in all): a few thousand f32
// operations per node, so the launch is bound by operations. The design keeps
// it to ONE launch per J.v and accepts the 4x recomputation in exchange for
// no scatter and no atomics.

#include "phys_ch3d.cuh"

PFH_EXPORT int pfh_jvp3_param_floats() { return pfh::kJvp3ParamFloats; }

PFH_EXPORT int pfh_ch3d_jvp(const float* params, int nq, const float* wv,
                            const float* tv, const float* bv, float* ov, int nz,
                            int ny, int nx, void* stream) {
  return pfh::launch_fem_jvp3d<pfh::CH3>(params, nq, wv, tv, bv, ov, nz, ny, nx,
                                    stream);
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of I at
// nq points (common.cuh kernel_info; chip_smoke.py phase 11).
PFH_EXPORT int pfh_ch3d_jvp_info(int nq, int* out) {
  using pfh::CH3;
  switch (nq) {
    case 8: return pfh::kernel_info(pfh::fem_jvp3d_kernel<CH3, 8>, pfh::kThreads, 0, out);
    case 4: return pfh::kernel_info(pfh::fem_jvp3d_kernel<CH3, 4>, pfh::kThreads, 0, out);
    case 1: return pfh::kernel_info(pfh::fem_jvp3d_kernel<CH3, 1>, pfh::kThreads, 0, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
