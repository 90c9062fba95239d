// Kernel S, shard_sweep: the per-shard sweep body of the sharded LMR
// smoother (shard_sweep.cuh), instantiated for BM1's Cahn-Hilliard (CH,
// phys_ch.cuh: the JAX package's test and dry run) and BM3's Allen-Cahn +
// heat (ACH, phys_ach.cuh: its 350^2 fine level is the one 2D level that
// fills the card). Replaces the pallas_call of
// pfhubbenchmarks_tpu/parallel/halo_smoother.py:153.

#include "phys_ach.cuh"
#include "phys_ch.cuh"
#include "shard_sweep.cuh"

namespace {

pfh::ShardOperands operands(const float* pv, const float* pm, const float* rv,
                            const float* rm, const float* wv, const float* wm,
                            const float* mask, float* zv, float* zm, float* av,
                            float* am) {
  return pfh::ShardOperands{pv, pm, rv, rm, wv, wm, mask, zv, zm, av, am};
}

}  // namespace

PFH_EXPORT int pfh_shard_sweep_ch(const float* params, int nq, const float* pv,
                                  const float* pm, const float* rv,
                                  const float* rm, const float* wv,
                                  const float* wm, const float* mask, float* zv,
                                  float* zm, float* av, float* am, int by,
                                  int bx, void* stream) {
  return pfh::launch_shard_sweep<pfh::CH>(
      params, nq, operands(pv, pm, rv, rm, wv, wm, mask, zv, zm, av, am), by,
      bx, stream);
}

PFH_EXPORT int pfh_shard_sweep_ach(const float* params, int nq, const float* pv,
                                   const float* pm, const float* rv,
                                   const float* rm, const float* wv,
                                   const float* wm, const float* mask,
                                   float* zv, float* zm, float* av, float* am,
                                   int by, int bx, void* stream) {
  return pfh::launch_shard_sweep<pfh::ACH>(
      params, nq, operands(pv, pm, rv, rm, wv, wm, mask, zv, zm, av, am), by,
      bx, stream);
}
