// Kernel N, node_blocks, for BM3's isotropic Allen-Cahn + heat (phys_ach.cuh):
// the node-block-Jacobi inverses of one 2D multigrid level in one launch
// (node_blocks.cuh).

#include "node_blocks.cuh"
#include "phys_ach.cuh"

PFH_EXPORT int pfh_node_blocks_ach(const float* params, const float* wv,
                                  const float* wm, const float* diag,
                                  const float* mask, float* pv, float* pm,
                                  long nvert, long ncell, void* stream) {
  return pfh::node_blocks<pfh::ACH>(params, wv, wm, diag, mask, pv, pm, nvert,
                                   ncell, stream);
}

PFH_EXPORT int pfh_node_blocks_ach_info(int* out) {
  return pfh::node_blocks_info<pfh::ACH>(out);
}
