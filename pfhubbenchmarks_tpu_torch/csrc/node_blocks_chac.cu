// Kernel N, node_blocks, for BM2's Cahn-Hilliard + NE Allen-Cahn
// (phys_chac.cuh), NE in {1, 2, 4}, the coupled or the field-split tangent:
// the node-block-Jacobi inverses of one 2D multigrid level in one launch,
// and of every level of a hierarchy with the build's state injections in
// one launch (node_build_kernel; node_blocks.cuh). Under the split the cross-group entries are exact
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

template <int NE>
int build_ne(bool split, const float* params, const long long* rec, int nlev,
             long total, const float* wv, const float* wm, const float* w0v,
             const float* w0m, const float* diag, const float* mask,
             const int* src, float* planes, float* states, void* stream) {
  return split ? pfh::node_build<pfh::CHAC<NE, true>>(
                     params, rec, nlev, total, wv, wm, w0v, w0m, diag, mask,
                     src, planes, states, stream)
               : pfh::node_build<pfh::CHAC<NE, false>>(
                     params, rec, nlev, total, wv, wm, w0v, w0m, diag, mask,
                     src, planes, states, stream);
}

template <int NE>
int build_info_ne(bool split, int* out) {
  return split ? pfh::node_build_info<pfh::CHAC<NE, true>>(out)
               : pfh::node_build_info<pfh::CHAC<NE, false>>(out);
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

// The one-launch build over every level of a hierarchy (node_build_kernel);
// ne and split as above.
PFH_EXPORT int pfh_node_build_chac(const float* params, int ne, int split,
                                   const long long* rec, int nlev, long total,
                                   const float* wv, const float* wm,
                                   const float* w0v, const float* w0m,
                                   const float* diag, const float* mask,
                                   const int* src, float* planes,
                                   float* states, void* stream) {
  switch (ne) {
    case 1:
      return build_ne<1>(split != 0, params, rec, nlev, total, wv, wm, w0v,
                         w0m, diag, mask, src, planes, states, stream);
    case 2:
      return build_ne<2>(split != 0, params, rec, nlev, total, wv, wm, w0v,
                         w0m, diag, mask, src, planes, states, stream);
    case 4:
      return build_ne<4>(split != 0, params, rec, nlev, total, wv, wm, w0v,
                         w0m, diag, mask, src, planes, states, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

PFH_EXPORT int pfh_node_build_chac_info(int ne, int split, int* out) {
  switch (ne) {
    case 1:
      return build_info_ne<1>(split != 0, out);
    case 2:
      return build_info_ne<2>(split != 0, out);
    case 4:
      return build_info_ne<4>(split != 0, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
