// Kernel N, node_blocks, for BM2's Cahn-Hilliard + NE Allen-Cahn
// (phys_chac.cuh), NE in {1, 2, 4}, the coupled or the field-split tangent:
// the node-block-Jacobi inverses of one 2D multigrid level in one launch
// (node_blocks.cuh). Under the split the cross-group entries are exact
// zeros, kept in the planes as solve/precond.small_inv keeps them.

#include "node_blocks.cuh"
#include "phys_chac.cuh"

namespace {

template <int NE>
int launch_ne(bool split, const float* params, const float* wv,
              const float* wm, const float* diag, const float* mask, float* pv,
              float* pm, long nvert, long ncell, void* stream) {
  return split ? pfh::node_blocks<pfh::CHAC<NE, true>>(
                     params, wv, wm, diag, mask, pv, pm, nvert, ncell, stream)
               : pfh::node_blocks<pfh::CHAC<NE, false>>(
                     params, wv, wm, diag, mask, pv, pm, nvert, ncell, stream);
}

template <int NE>
int info_ne(bool split, int* out) {
  return split ? pfh::node_blocks_info<pfh::CHAC<NE, true>>(out)
               : pfh::node_blocks_info<pfh::CHAC<NE, false>>(out);
}

}  // namespace

// ne: the number of Allen-Cahn fields (1, 2 or 4); split: 0 for the coupled
// tangent, 1 for the field-split one.
PFH_EXPORT int pfh_node_blocks_chac(const float* params, int ne, int split,
                                    const float* wv, const float* wm,
                                    const float* diag, const float* mask,
                                    float* pv, float* pm, long nvert,
                                    long ncell, void* stream) {
  switch (ne) {
    case 1:
      return launch_ne<1>(split != 0, params, wv, wm, diag, mask, pv, pm,
                          nvert, ncell, stream);
    case 2:
      return launch_ne<2>(split != 0, params, wv, wm, diag, mask, pv, pm,
                          nvert, ncell, stream);
    case 4:
      return launch_ne<4>(split != 0, params, wv, wm, diag, mask, pv, pm,
                          nvert, ncell, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

PFH_EXPORT int pfh_node_blocks_chac_info(int ne, int split, int* out) {
  switch (ne) {
    case 1:
      return info_ne<1>(split != 0, out);
    case 2:
      return info_ne<2>(split != 0, out);
    case 4:
      return info_ne<4>(split != 0, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
