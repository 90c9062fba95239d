// Kernel N, node_blocks, for BM1's Cahn-Hilliard (phys_ch.cuh):
// the node-block-Jacobi inverses of one 2D multigrid level in one launch,
// and of every level of a hierarchy with the build's state injections in
// one launch (node_build_kernel; node_blocks.cuh).

#include "node_blocks.cuh"
#include "phys_ch.cuh"

namespace pfh {

// BM1's source column in the order of operations in which torch's forward
// mode differentiates bench1's terms (benchmarks/bench1.py: src_c =
// (c - c0) / dt, src_mu = mu - dfdc(c) with dfdc = 2 rho_s (c - c_a)
// (c_b - c) ((c_b - c) - (c - c_a)), evaluated left to right), every
// operation rounded on its own: the product rule d(x y) = dy x + dx y of
// each mul, a scalar divisor as a product with its f32 reciprocal (torch's
// CUDA division by a host scalar). In the direction e_1 (mu) the source
// column is (0, 1); in e_0 (c) it is (1/dt, -d dfdc) with
//   A = c - c_a, B = c_b - c, X1 = 2 rho_s A, X2 = X1 B, C = B - A,
//   dX2 = -X1 + 2 rho_s B, d dfdc = -2 X2 + dX2 C.
template <>
struct BlockSource<CH> {
  static constexpr bool kExact = true;
  __device__ __forceinline__ static void column(const JvpParams& P,
                                                const float (&u)[CH::NS],
                                                int j, float (&src)[CH::NF]) {
    if (j == 1) {
      src[0] = 0.0f;
      src[1] = 1.0f;
      return;
    }
    const float c = u[0];
    const float K = 2.0f * P.k[2];  // 2 rho_s, exact
    const float A = __fsub_rn(c, P.k[3]);
    const float B = __fsub_rn(P.k[4], c);
    const float X1 = __fmul_rn(A, K);
    const float X2 = __fmul_rn(X1, B);
    const float C = __fsub_rn(B, A);
    const float dX2 = __fadd_rn(-X1, __fmul_rn(K, B));
    const float d_dfdc = __fadd_rn(-2.0f * X2, __fmul_rn(dX2, C));
    src[0] = __fdiv_rn(1.0f, P.dt);
    src[1] = -d_dfdc;
  }
};

}  // namespace pfh

PFH_EXPORT int pfh_node_blocks_ch(const float* params, const float* wv,
                                  const float* wm, const float* diag,
                                  const float* mask, float* pv, float* pm,
                                  long nvert, long ncell, void* stream) {
  return pfh::node_blocks<pfh::CH>(params, wv, wm, diag, mask, pv, pm, nvert,
                                   ncell, stream);
}

PFH_EXPORT int pfh_node_blocks_ch_info(int* out) {
  return pfh::node_blocks_info<pfh::CH>(out);
}

// The one-launch build over every level of a hierarchy (node_build_kernel).
PFH_EXPORT int pfh_node_build_ch(const float* params, const long long* rec,
                                 int nlev, long total, const float* wv,
                                 const float* wm, const float* w0v,
                                 const float* w0m, const float* diag,
                                 const float* mask, const int* src,
                                 float* planes, float* states, void* stream) {
  return pfh::node_build<pfh::CH>(params, rec, nlev, total, wv, wm, w0v,
                                  w0m, diag, mask, src, planes, states,
                                  stream);
}

PFH_EXPORT int pfh_node_build_ch_info(int* out) {
  return pfh::node_build_info<pfh::CH>(out);
}
