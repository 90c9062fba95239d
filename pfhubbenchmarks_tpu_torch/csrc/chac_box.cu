// Kernel W at BM2's physics, chac_box: the coupled J.v of the Cahn-Hilliard
// + NE Allen-Cahn weak form over triangle boxes, (w, dt, v) -> (Jv_v, Jv_m),
// f32; fields (c, mu, eta_1..eta_NE), NE in {1, 2, 4}, the 4-point rule.
//
// Replaces, on bench2's and bench2_eta1's outer Krylov J.v and exported A z
// (the ffc3 fine grid, the coupled operator), kernel F (chac_jvp.cu), and
// with it pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp (:198)
// at BM2's physics. The body is fem_tri_box.cuh's, the tangent
// phys_chac.cuh's CHAC<NE, false>; the field-split operator runs inside
// kernel L and the chains only, so it has no instantiation here.
//
// What bounds it on the H100: at BM2's 100^2 one launch reads ~0.9 MB (the
// 5 state and 6 tangent planes of 20,201 nodes; 1.4 MB with b) and writes
// 0.5 MB, bytes 0.75 us; it evaluates 10,000 x 4 x 4 tangents once each (x
// 1.31 for the halo) where F evaluated each three times. Boxes of 7 x 7
// vertices: 225 CTAs of 256 threads, two per SM, one wave.

#include "fem_tri_box.cuh"
#include "phys_chac.cuh"

namespace {

using ChacBox = pfh::TriBox<7, 7, 2, 1>;

template <int NE>
int launch_ne(const float* params, int nq, int by, int bx, const float* wv,
              const float* wm, const float* tv, const float* tm,
              const float* bv, const float* bm, const float* mask, float* ov,
              float* om, int ny, int nx, void* stream) {
  return pfh::launch_tri_box<pfh::CHAC<NE, false>, ChacBox>(
      params, nq, by, bx, wv, wm, tv, tm, bv, bm, mask, ov, om, ny, nx,
      stream);
}

}  // namespace

// ne: the number of Allen-Cahn fields (1, 2 or 4); by, bx: the box the
// caller planned with (ops/tri_box.py TRI_BOX["chac"]).
PFH_EXPORT int pfh_chac_box(const float* params, int nq, int ne, int by,
                            int bx, const float* wv, const float* wm,
                            const float* tv, const float* tm, const float* bv,
                            const float* bm, const float* mask, float* ov,
                            float* om, int ny, int nx, void* stream) {
  switch (ne) {
    case 1:
      return launch_ne<1>(params, nq, by, bx, wv, wm, tv, tm, bv, bm, mask,
                          ov, om, ny, nx, stream);
    case 2:
      return launch_ne<2>(params, nq, by, bx, wv, wm, tv, tm, bv, bm, mask,
                          ov, om, ny, nx, stream);
    case 4:
      return launch_ne<4>(params, nq, by, bx, wv, wm, tv, tm, bv, bm, mask,
                          ov, om, ny, nx, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers, spill bytes, shared bytes and co-resident CTAs per SM of W at
// ne order parameters (common.cuh kernel_info).
PFH_EXPORT int pfh_chac_box_info(int ne, int* out) {
  switch (ne) {
    case 1: return pfh::tri_box_info<pfh::CHAC<1, false>, ChacBox>(out);
    case 2: return pfh::tri_box_info<pfh::CHAC<2, false>, ChacBox>(out);
    case 4: return pfh::tri_box_info<pfh::CHAC<4, false>, ChacBox>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
