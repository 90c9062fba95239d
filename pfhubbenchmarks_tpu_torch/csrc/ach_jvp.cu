// Kernel G, ach_jvp: J.v of BM3's Allen-Cahn + heat weak form (dendritic
// solidification without anisotropy) on the crossed-P1 grid,
// (w, dt, v) -> (Jv_v, Jv_m), f32; fields (U, phi).
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp at
// BM3's physics (the outer Krylov J.v and the exported A z on the 350^2
// ffc3 grid) and the in-kernel A.z of ops/pallas_vcycle.py:
// make_fused_descend and make_fused_ascend (the dunavant2 levels). The
// gather body is fem_jvp.cuh's, the pointwise tangent phys_ach.cuh's
// (mirrored by benchmarks/bench3.py:terms_tangent). Unlike kernels A and E
// the tangent reads two state planes (U and phi).
//
// What bounds it on the H100: at BM3's 350^2 one launch reads ~3.9 MB (2
// state and 2 tangent planes of 245,701 nodes; 5.9 MB with b) and writes
// 2.0 MB, and the 4-point rule makes it the heaviest J.v of the port in
// operations per node; ~1,900 blocks of 128 threads fill the card's 132
// SMs over several waves, the first J.v of the port that is not one
// partial wave.

#include "fem_jvp.cuh"
#include "phys_ach.cuh"

PFH_EXPORT int pfh_ach_jvp(const float* params, int nq, const float* wv,
                           const float* wm, const float* tv, const float* tm,
                           const float* bv, const float* bm, const float* mask,
                           float* ov, float* om, int ny, int nx, void* stream) {
  return pfh::launch_fem_jvp<pfh::ACH>(params, nq, wv, wm, tv, tm, bv, bm, mask, ov,
                                  om, ny, nx, stream);
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of G at
// nq points (common.cuh kernel_info; tools/torch_tile_probe.py).
PFH_EXPORT int pfh_ach_jvp_info(int nq, int* out) {
  if (nq == 3)
    return pfh::kernel_info(pfh::fem_jvp_kernel<pfh::ACH, 3>, pfh::kThreads, 0,
                            out);
  if (nq == 4)
    return pfh::kernel_info(pfh::fem_jvp_kernel<pfh::ACH, 4>, pfh::kThreads, 0,
                            out);
  return static_cast<int>(cudaErrorInvalidValue);
}
