// Kernels vcycle_descend_chain and vcycle_ascend_chain (vcycle_chain.cuh)
// for BM2's Cahn-Hilliard + 4 Allen-Cahn fields (kernel F's physics,
// phys_chac.cuh), the coupled and the field-split operator, with field
// groups: one source per NE, so that nvcc builds the three in parallel;
// vcycle_chain_chac.cu dispatches.

#include "phys_chac.cuh"
#include "vcycle_chain.cuh"

namespace pfh {

int vcycle_chain_chac4(int split, int ascend, int nq, const void* table,
                       int K, long need, const float* bv, const float* bm,
                       const float* xcv, const float* xcm, float* zv,
                       float* zm, int* grid_out, void* stream) {
  return split ? vcycle_chain<CHAC<4, true>>(ascend, nq, table, K, need, bv,
                                             bm, xcv, xcm, zv, zm, grid_out,
                                             stream)
               : vcycle_chain<CHAC<4, false>>(ascend, nq, table, K, need, bv,
                                              bm, xcv, xcm, zv, zm, grid_out,
                                              stream);
}

int vcycle_chain_chac4_info(int split, int ascend, int nq, int* out) {
  return split ? vcycle_chain_info<CHAC<4, true>>(ascend, nq, out)
               : vcycle_chain_info<CHAC<4, false>>(ascend, nq, out);
}

}  // namespace pfh
