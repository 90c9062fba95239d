// Kernel F, chac_jvp: J.v of BM2's Cahn-Hilliard + NE Allen-Cahn weak form
// on the crossed-P1 grid, (w, dt, v) -> (Jv_v, Jv_m), f32; fields
// (c, mu, eta_1..eta_NE), NE in {1, 2, 4}.
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp at
// BM2's physics (the outer Krylov J.v) and the in-kernel A.z of
// make_fused_vcycle, make_pallas_lmr_sweep_loop, make_pallas_lmr_sweep and
// make_tiled_lmr_sweep. Two operators:
//   - coupled (SPLIT = false): the tangent of benchmarks/bench2.py's terms,
//     for the outer J.v and the exported A z (the ffc3 fine grid);
//   - split (SPLIT = true): the tangent of terms_precond, whose cross-group
//     couplings are stopped, so the Jacobian is diag(J_CH, J_AC1..J_ACNE);
//     for every multigrid level (the dunavant1 rule).
// The gather body is fem_jvp.cuh's, the pointwise tangents
// phys_chac.cuh's (mirrored by benchmarks/bench2.py's terms_tangent and
// terms_tangent_split).
//
// What bounds it on the H100: at BM2's 100^2 one launch reads ~0.9 MB (the
// 5 state planes and 6 tangent planes of 20,201 nodes each; 1.4 MB with b)
// and writes 0.5 MB, all L2-resident; a launch is one wave of ~160 blocks,
// latency-bound like kernels A and E.

#include "fem_jvp.cuh"
#include "phys_chac.cuh"

namespace {

template <int NE>
int launch_ne(bool split, const float* params, int nq, const float* wv,
              const float* wm, const float* tv, const float* tm,
              const float* bv, const float* bm, const float* mask, float* ov,
              float* om, int ny, int nx, void* stream) {
  return split ? pfh::launch_fem_jvp<pfh::CHAC<NE, true>>(
                     params, nq, wv, wm, tv, tm, bv, bm, mask, ov, om, ny, nx, stream)
               : pfh::launch_fem_jvp<pfh::CHAC<NE, false>>(
                     params, nq, wv, wm, tv, tm, bv, bm, mask, ov, om, ny, nx, stream);
}

}  // namespace

// ne: the number of Allen-Cahn fields (1, 2 or 4); split: 0 for the coupled
// operator, 1 for the field-split one.
PFH_EXPORT int pfh_chac_jvp(const float* params, int nq, int ne, int split,
                            const float* wv, const float* wm, const float* tv,
                            const float* tm, const float* bv, const float* bm,
                            const float* mask, float* ov, float* om, int ny,
                            int nx, void* stream) {
  switch (ne) {
    case 1:
      return launch_ne<1>(split != 0, params, nq, wv, wm, tv, tm, bv, bm, mask,
                          ov, om, ny, nx, stream);
    case 2:
      return launch_ne<2>(split != 0, params, nq, wv, wm, tv, tm, bv, bm, mask,
                          ov, om, ny, nx, stream);
    case 4:
      return launch_ne<4>(split != 0, params, nq, wv, wm, tv, tm, bv, bm, mask,
                          ov, om, ny, nx, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
