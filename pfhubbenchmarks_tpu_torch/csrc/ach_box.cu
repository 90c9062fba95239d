// Kernel W at BM3's physics, ach_box: the J.v of the Allen-Cahn + heat weak
// form (no anisotropy) over triangle boxes, (w, dt, v) -> (Jv_v, Jv_m), f32;
// fields (U, phi), the 4-point rule.
//
// Replaces, on bench3's outer Krylov J.v and exported A z (the 350^2 ffc3
// grid), kernel G (ach_jvp.cu), and with it
// pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp (:198) at BM3's
// physics. The body is fem_tri_box.cuh's, the tangent phys_ach.cuh's.
//
// What bounds it on the H100: operations, 2.57 us by the f32 count at
// 350^2 (each of the 122,500 x 4 x 4 tangents once, x 1.22 for the halo,
// where G evaluated each three times); one launch reads ~3.9 MB (5.9 MB with
// b) and writes 2.0 MB. Boxes of 7 x 15 vertices: 1,224 CTAs of 512
// threads, three per SM.

#include "fem_tri_box.cuh"
#include "phys_ach.cuh"

namespace {

// three CTAs of 512 threads per SM (40 registers): 22.8 us at 350^2 against
// 25.5 at two (tools/torch_tri_box_probe.py)
using AchBox = pfh::TriBox<7, 15, 3, 1>;

}  // namespace

// by, bx: the box the caller planned with (ops/tri_box.py TRI_BOX["ach"]).
PFH_EXPORT int pfh_ach_box(const float* params, int nq, int by, int bx,
                           const float* wv, const float* wm, const float* tv,
                           const float* tm, const float* bv, const float* bm,
                           const float* mask, float* ov, float* om, int ny,
                           int nx, void* stream) {
  return pfh::launch_tri_box<pfh::ACH, AchBox>(
      params, nq, by, bx, wv, wm, tv, tm, bv, bm, mask, ov, om, ny, nx,
      stream);
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of W
// (common.cuh kernel_info).
PFH_EXPORT int pfh_ach_box_info(int* out) {
  return pfh::tri_box_info<pfh::ACH, AchBox>(out);
}
