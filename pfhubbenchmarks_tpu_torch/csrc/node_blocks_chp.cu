// Kernel N, node_blocks, for BM6's Cahn-Hilliard + Poisson (phys_chp.cuh), with the Dirichlet mask of phi's edges:
// the node-block-Jacobi inverses of one 2D multigrid level in one launch,
// and of every level of a hierarchy with the build's state injections in
// one launch (node_build_kernel; node_blocks.cuh).

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

// The one-launch build over every level of a hierarchy (node_build_kernel).
PFH_EXPORT int pfh_node_build_chp(const float* params, const long long* rec,
                                  int nlev, long total, const float* wv,
                                  const float* wm, const float* w0v,
                                  const float* w0m, const float* diag,
                                  const float* mask, const int* src,
                                  float* planes, float* states, void* stream) {
  return pfh::node_build<pfh::CHP>(params, rec, nlev, total, wv, wm, w0v,
                                   w0m, diag, mask, src, planes, states,
                                   stream);
}

PFH_EXPORT int pfh_node_build_chp_info(int* out) {
  return pfh::node_build_info<pfh::CHP>(out);
}
