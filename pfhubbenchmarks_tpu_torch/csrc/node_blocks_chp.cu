// Kernel N, node_blocks, for BM6's Cahn-Hilliard + Poisson (phys_chp.cuh), with the Dirichlet mask of phi's edges:
// the node-block-Jacobi inverses of one 2D multigrid level in one launch
// (node_blocks.cuh).

#include "node_blocks.cuh"
#include "phys_chp.cuh"

PFH_EXPORT int pfh_node_blocks_chp(const float* params, const float* wv,
                                  const float* wm, const float* diag,
                                  const float* mask, float* pv, float* pm,
                                  long nvert, long ncell, void* stream) {
  return pfh::node_blocks<pfh::CHP>(params, wv, wm, diag, mask, pv, pm, nvert,
                                   ncell, stream);
}

PFH_EXPORT int pfh_node_blocks_chp_info(int* out) {
  return pfh::node_blocks_info<pfh::CHP>(out);
}
