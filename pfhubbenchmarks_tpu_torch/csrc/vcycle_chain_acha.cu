// Kernels vcycle_descend_chain and vcycle_ascend_chain (vcycle_chain.cuh)
// at the anisotropic BM3's physics (phys_acha.cuh): each chain of V-cycle
// levels in one cooperative launch, at rules of 1, 3 or 4 points, the level
// J.v's tangent reading the state's gradient. Replace, at this physics, TPU
// rows 6-9 (pallas_vcycle.py make_fused_descend, make_fused_descend_chain,
// make_fused_ascend_chain, make_fused_ascend), which take jax.jvp of the
// anisotropic terms in-kernel, and the sweep body of rows 3, 4 and 11.

#include "phys_acha.cuh"
#include "vcycle_chain.cuh"

// ascend: 0 the descent, 1 the ascent; the rest as pfh::vcycle_chain takes it
PFH_EXPORT int pfh_vcycle_chain_acha(int ascend, int nq, const void* table,
                                     int K, long need, const float* bv,
                                     const float* bm, const float* xcv,
                                     const float* xcm, float* zv, float* zm,
                                     int* grid_out, void* stream) {
  return pfh::vcycle_chain<pfh::ACHA>(ascend, nq, table, K, need, bv, bm, xcv,
                                      xcm, zv, zm, grid_out, stream);
}

PFH_EXPORT int pfh_vcycle_chain_acha_info(int ascend, int nq, int* out) {
  return pfh::vcycle_chain_info<pfh::ACHA>(ascend, nq, out);
}
