// Kernel V (vcycle_fused.cuh) for BM1's Cahn-Hilliard (kernel A's physics,
// phys_ch.cuh): the levels at dunavant2 (3 points), the exported A z at the
// outer ffc3 rule (4 points). Replaces, at this physics, TPU row 5
// (pallas_vcycle.py make_fused_vcycle with with_matvec=True).

#include "phys_ch.cuh"
#include "vcycle_fused.cuh"

namespace {
using V = pfh::CH;
}

// nq, mv_nq: the levels' and the matvec's point counts (3 and 4); the rest
// as pfh::vcycle_fused takes it
PFH_EXPORT int pfh_vcycle_fused_ch(int nq, int mv_nq, const void* table, int K,
                                   long need, int cluster, int cluster_from,
                                   int phases, const float* bv, const float* bm,
                                   float* zv, float* zm, float* av, float* am,
                                   int* grid_out, void* stream) {
  return pfh::vcycle_fused<V, 3, V, 4>(nq, mv_nq, table, K, need, cluster,
                                       cluster_from, phases, bv, bm, zv, zm,
                                       av, am, grid_out, stream);
}

PFH_EXPORT int pfh_vcycle_fused_ch_info(int cluster, int* out) {
  return pfh::vcycle_fused_info<V, 3, V, 4>(cluster, out);
}
