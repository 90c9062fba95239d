// Kernel A, ch_jvp: J.v of BM1's mixed Cahn-Hilliard weak form on the
// crossed-P1 grid, (w, dt, v) -> (Jv_v, Jv_m), f32; fields (c, mu).
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp (the
// outer Krylov matvec) and the in-kernel A.z of
// pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_vcycle (per-level
// smoothing and residual J.v, and the exported true-rule pair). The gather
// body is fem_jvp.cuh's, BM1's pointwise tangent phys_ch.cuh's (the
// mirror of benchmarks/bench1.py:terms_tangent). It does not depend on the
// previous time level, so w0 is not an argument.
//
// What bounds it on the H100: at BM1's 100^2 one launch reads ~0.5 MB and
// does ~20 MFLOP, all of it L2-resident (the whole hierarchy is a few MB of
// the 50 MB L2), so a launch is latency-bound (launch + one wave of ~160
// blocks). The design keeps it to ONE launch per J.v.

#include "fem_jvp.cuh"
#include "phys_ch.cuh"

PFH_EXPORT int pfh_jvp_param_floats() { return pfh::kJvpParamFloats; }

PFH_EXPORT int pfh_ch_jvp(const float* params, int nq, const float* wv,
                          const float* wm, const float* tv, const float* tm,
                          const float* bv, const float* bm, const float* mask,
                          float* ov, float* om, int ny, int nx, void* stream) {
  return pfh::launch_fem_jvp<pfh::CH>(params, nq, wv, wm, tv, tm, bv, bm, mask, ov,
                                 om, ny, nx, stream);
}
