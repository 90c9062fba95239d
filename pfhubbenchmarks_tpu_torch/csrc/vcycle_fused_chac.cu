// Kernel V (vcycle_fused.cuh) for BM2's Cahn-Hilliard + NE Allen-Cahn
// (kernel F's physics, phys_chac.cuh), NE in {1, 2, 4}: the levels run the
// field-split operator at dunavant1 (1 point), the exported A z the coupled
// one at the outer ffc3 rule (4 points). Replaces, at this physics, TPU row
// 5 (pallas_vcycle.py make_fused_vcycle with with_matvec=True and
// field_groups).

#include "phys_chac.cuh"
#include "vcycle_fused.cuh"

namespace {

template <int NE>
int fused(int nq, int mv_nq, const void* table, int K, long need, int cluster,
          int cluster_from, int phases, const float* bv, const float* bm,
          float* zv, float* zm, float* av, float* am, int* grid_out,
          void* stream) {
  return pfh::vcycle_fused<pfh::CHAC<NE, true>, 1, pfh::CHAC<NE, false>, 4>(
      nq, mv_nq, table, K, need, cluster, cluster_from, phases, bv, bm, zv,
      zm, av, am, grid_out, stream);
}

template <int NE>
int info(int cluster, int* out) {
  return pfh::vcycle_fused_info<pfh::CHAC<NE, true>, 1, pfh::CHAC<NE, false>,
                                4>(cluster, out);
}

}  // namespace

// ne: the number of Allen-Cahn fields (1, 2 or 4); the rest as
// pfh_vcycle_fused_ch takes it
PFH_EXPORT int pfh_vcycle_fused_chac(int nq, int mv_nq, int ne,
                                     const void* table, int K, long need,
                                     int cluster, int cluster_from, int phases,
                                     const float* bv, const float* bm,
                                     float* zv, float* zm, float* av,
                                     float* am, int* grid_out, void* stream) {
  switch (ne) {
#define PFH_FUSED_NE(N)                                                     \
  case N:                                                                   \
    return fused<N>(nq, mv_nq, table, K, need, cluster, cluster_from,       \
                    phases, bv, bm, zv, zm, av, am, grid_out, stream);
    PFH_FUSED_NE(1)
    PFH_FUSED_NE(2)
    PFH_FUSED_NE(4)
#undef PFH_FUSED_NE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

PFH_EXPORT int pfh_vcycle_fused_chac_info(int ne, int cluster, int* out) {
  switch (ne) {
    case 1:
      return info<1>(cluster, out);
    case 2:
      return info<2>(cluster, out);
    case 4:
      return info<4>(cluster, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
