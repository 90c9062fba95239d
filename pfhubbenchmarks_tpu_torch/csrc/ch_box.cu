// Kernel W at BM1's physics, ch_box: the J.v of the mixed Cahn-Hilliard
// weak form over triangle boxes, (w, dt, v) -> (Jv_v, Jv_m), f32; fields
// (c, mu), the 4-point rule.
//
// Replaces, on bench1's outer Krylov J.v and exported A z (the 100^2 ffc3
// grid), kernel A (ch_jvp.cu), and with it
// pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp (:198) at BM1's
// physics. The body is fem_tri_box.cuh's, the tangent phys_ch.cuh's; A stays
// built, and its per-node body runs every multigrid level (kernel L, the
// chains).
//
// What bounds it on the H100: at BM1's 100^2 one launch reads ~0.24 MB (the
// c plane and the 2 tangent planes of 20,201 nodes; 0.4 MB with b) and
// writes 0.16 MB, bytes 0.12 us; its f32 operations 0.160 us. It evaluates
// 10,000 x 4 x 4 tangents once each (x 1.31 for the halo) where A evaluated
// each three times. The shared terms are 384 B a cell: 26,316 B for a 7 x 7
// box.
//
// Measured on an H100 (80GB HBM3, 700 W; tools/torch_tri_box_probe.py ch):
// at 100^2 every box of 7 x 7, 3 x 7 or 7 x 15 vertices took 5.3-5.7 us
// against A's 6.9 (3 x 3 and 5 x 5 6.3-6.5: their halo recompute is
// 1.44-1.77x); two threads per triangle (two points each) took 5.34 us
// against one's 5.46, four 7.75 (one CTA per SM).

#include "fem_tri_box.cuh"
#include "phys_ch.cuh"

namespace {

// 7 x 7 vertices, two threads per triangle: 512 threads, 48 registers, two
// CTAs per SM
using ChBox = pfh::TriBox<7, 7, 2, 2>;

}  // namespace

// by, bx: the box the caller planned with (ops/tri_box.py TRI_BOX["ch"]).
PFH_EXPORT int pfh_ch_box(const float* params, int nq, int by, int bx,
                          const float* wv, const float* wm, const float* tv,
                          const float* tm, const float* bv, const float* bm,
                          const float* mask, float* ov, float* om, int ny,
                          int nx, void* stream) {
  return pfh::launch_tri_box<pfh::CH, ChBox>(
      params, nq, by, bx, wv, wm, tv, tm, bv, bm, mask, ov, om, ny, nx,
      stream);
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of W at
// BM1's physics (common.cuh kernel_info).
PFH_EXPORT int pfh_ch_box_info(int* out) {
  return pfh::tri_box_info<pfh::CH, ChBox>(out);
}
