// Kernels vcycle_descend_chain and vcycle_ascend_chain (vcycle_chain.cuh)
// for BM2's Cahn-Hilliard + NE Allen-Cahn (kernel F's physics), NE in
// {1, 2, 4}: the dispatch over NE to vcycle_chain_chac{1,2,4}.cu. Replace,
// at this physics, TPU rows 6-9 (pallas_vcycle.py make_fused_descend,
// make_fused_descend_chain, make_fused_ascend_chain, make_fused_ascend).

#include "common.cuh"

namespace pfh {

int vcycle_chain_chac1(int split, int ascend, int nq, const void* table,
                       int K, long need, const float* bv, const float* bm,
                       const float* xcv, const float* xcm, float* zv,
                       float* zm, int* grid_out, void* stream);
int vcycle_chain_chac1_info(int split, int ascend, int nq, int* out);
int vcycle_chain_chac2(int split, int ascend, int nq, const void* table,
                       int K, long need, const float* bv, const float* bm,
                       const float* xcv, const float* xcm, float* zv,
                       float* zm, int* grid_out, void* stream);
int vcycle_chain_chac2_info(int split, int ascend, int nq, int* out);
int vcycle_chain_chac4(int split, int ascend, int nq, const void* table,
                       int K, long need, const float* bv, const float* bm,
                       const float* xcv, const float* xcm, float* zv,
                       float* zm, int* grid_out, void* stream);
int vcycle_chain_chac4_info(int split, int ascend, int nq, int* out);

}  // namespace pfh

// ne: the number of Allen-Cahn fields (1, 2 or 4); split: 0 for the coupled
// operator, 1 for the field-split one; the rest as pfh::vcycle_chain takes it
PFH_EXPORT int pfh_vcycle_chain_chac(int ascend, int nq, int ne, int split,
                                     const void* table, int K, long need,
                                     const float* bv, const float* bm,
                                     const float* xcv, const float* xcm,
                                     float* zv, float* zm, int* grid_out,
                                     void* stream) {
  switch (ne) {
    case 1:
      return pfh::vcycle_chain_chac1(split, ascend, nq, table, K, need, bv, bm,
                                     xcv, xcm, zv, zm, grid_out, stream);
    case 2:
      return pfh::vcycle_chain_chac2(split, ascend, nq, table, K, need, bv, bm,
                                     xcv, xcm, zv, zm, grid_out, stream);
    case 4:
      return pfh::vcycle_chain_chac4(split, ascend, nq, table, K, need, bv, bm,
                                     xcv, xcm, zv, zm, grid_out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

PFH_EXPORT int pfh_vcycle_chain_chac_info(int ascend, int nq, int ne, int split,
                                          int* out) {
  switch (ne) {
    case 1:
      return pfh::vcycle_chain_chac1_info(split, ascend, nq, out);
    case 2:
      return pfh::vcycle_chain_chac2_info(split, ascend, nq, out);
    case 4:
      return pfh::vcycle_chain_chac4_info(split, ascend, nq, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
