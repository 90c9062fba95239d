// Kernel D, transfer_dyadic: prolongation, restriction (its exact
// transpose) and state injection between dyadic crossed-P1 levels
// (fine nx = 2 nxc, ny = 2 nyc), f32, as direct stencils.
//
// Replaces the in-kernel transfer matmuls of
// pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_vcycle (_LevelMats,
// built by ops/transfer_mats.py:build_transfer_mats). Those matmuls existed
// only because Mosaic rejects strided slices; the stencils here follow
// solve/transfer.py (prolong :37, restrict :70, inject_state :337).
//
// Design: one thread per (field, output node), the field on the grid's y
// axis, each running the node's body of transfer.cuh. Restriction is a
// gather per coarse node over its fine neighbourhood (no scatter, no
// atomics), each term added in the order of solve/transfer.py:restrict.
// Prolongation can accumulate into its output (x += P xc, the coarse-grid
// correction) to save a launch.
//
// Dirichlet rows (BM6's phi edges): an optional 0/1 vertex mask of the
// OUTPUT grid, [F, Yv, Xv] floats. Restriction writes 0 on the coarse BC
// rows, and prolongation leaves the fine BC rows untouched when it
// accumulates (writes 0 there otherwise). This is zero_bc_rows of
// pfhubbenchmarks_tpu/solve/gmg.py:633-648 and the keep masks of
// ops/pallas_vcycle.py:make_fused_descend_chain / make_fused_ascend_chain.
//
// What bounds it on the H100: a few hundred KB per call at BM1's 100^2 and
// 50^2, L2-resident: launch latency. Fields in parallel give F times the
// CTAs of one field (bench1's 100 -> 50 restriction: 80 CTAs, not 40). One
// launch per transfer.

#include "transfer.cuh"

namespace {

using namespace pfh::xfer;

// fine v [F, 2nyc+1, 2nxc+1], fine m [F, 2nyc, 2nxc] from coarse v, m
__global__ void __launch_bounds__(pfh::kThreads)
prolong_kernel(const float* __restrict__ vc, const float* __restrict__ mc,
               float* __restrict__ vf, float* __restrict__ mf,
               const float* __restrict__ mask, int nyc, int nxc,
               int accumulate) {
  const long nvf = static_cast<long>(2 * nyc + 1) * (2 * nxc + 1);
  const long nmf = 4L * nyc * nxc;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvf + nmf) return;
  const int f = blockIdx.y;
  const float* v = vc + f * static_cast<long>(nyc + 1) * (nxc + 1);
  const float* m = mc + f * static_cast<long>(nyc) * nxc;
  float val;
  float* out;
  if (idx < nvf) {
    const int nvxf = 2 * nxc + 1;
    val = dyadic_prolong_vertex(v, m, static_cast<int>(idx / nvxf),
                                static_cast<int>(idx % nvxf), nxc);
    if (mask != nullptr && __ldg(mask + f * nvf + idx) != 0.f) val = 0.f;
    out = vf + f * nvf + idx;
  } else {
    const long c = idx - nvf;
    const int nxf = 2 * nxc;
    val = dyadic_prolong_centre(v, m, static_cast<int>(c / nxf),
                                static_cast<int>(c % nxf), nxc);
    out = mf + f * nmf + c;
  }
  *out = accumulate ? *out + val : val;
}

// coarse = P^T fine
__global__ void __launch_bounds__(pfh::kThreads)
restrict_kernel(const float* __restrict__ vf, const float* __restrict__ mf,
                float* __restrict__ vc, float* __restrict__ mc,
                const float* __restrict__ mask, int nyc, int nxc) {
  const int nvxc = nxc + 1;
  const long nvc = static_cast<long>(nyc + 1) * nvxc;
  const long nmc = static_cast<long>(nyc) * nxc;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvc + nmc) return;
  const int f = blockIdx.y;
  const float* v = vf + f * static_cast<long>(2 * nyc + 1) * (2 * nxc + 1);
  const float* m = mf + f * 4L * nyc * nxc;
  if (idx < nvc) {
    float acc = dyadic_restrict_vertex(v, m, static_cast<int>(idx / nvxc),
                                       static_cast<int>(idx % nvxc), nyc, nxc);
    if (mask != nullptr && __ldg(mask + f * nvc + idx) != 0.f) acc = 0.f;
    vc[f * nvc + idx] = acc;
  } else {
    const long c = idx - nvc;
    mc[f * nmc + c] = dyadic_restrict_centre(v, m, static_cast<int>(c / nxc),
                                             static_cast<int>(c % nxc), nxc);
  }
}

__global__ void __launch_bounds__(pfh::kThreads)
inject_kernel(const float* __restrict__ vf, float* __restrict__ vc,
              float* __restrict__ mc, int nyc, int nxc) {
  const int nvxc = nxc + 1;
  const long nvc = static_cast<long>(nyc + 1) * nvxc;
  const long nmc = static_cast<long>(nyc) * nxc;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvc + nmc) return;
  const int f = blockIdx.y;
  const float* v = vf + f * static_cast<long>(2 * nyc + 1) * (2 * nxc + 1);
  if (idx < nvc) {
    vc[f * nvc + idx] = dyadic_inject_vertex(v, static_cast<int>(idx / nvxc),
                                             static_cast<int>(idx % nvxc), nxc);
  } else {
    const long c = idx - nvc;
    mc[f * nmc + c] = dyadic_inject_centre(v, static_cast<int>(c / nxc),
                                           static_cast<int>(c % nxc), nxc);
  }
}

}  // namespace

// op 0: prolong (src coarse -> dst fine; accumulate adds into dst)
// op 1: restrict (src fine -> dst coarse)
// op 2: inject (src fine -> dst coarse; src_m unused)
// mask: null, or the 0/1 Dirichlet vertex mask of dst (ops 0 and 1 only)
PFH_EXPORT int pfh_transfer(int op, const float* src_v, const float* src_m,
                            float* dst_v, float* dst_m, const float* mask,
                            int F, int nyc, int nxc, int accumulate,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long nvc = static_cast<long>(nyc + 1) * (nxc + 1);
  const long nmc = static_cast<long>(nyc) * nxc;
  const long nvf = static_cast<long>(2 * nyc + 1) * (2 * nxc + 1);
  const long nmf = 4L * nyc * nxc;
  if (F < 1 || F > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (op) {
    case 0:
      prolong_kernel<<<dim3(pfh::blocks_for(nvf + nmf), F), pfh::kThreads, 0, s>>>(
          src_v, src_m, dst_v, dst_m, mask, nyc, nxc, accumulate);
      break;
    case 1:
      restrict_kernel<<<dim3(pfh::blocks_for(nvc + nmc), F), pfh::kThreads, 0, s>>>(
          src_v, src_m, dst_v, dst_m, mask, nyc, nxc);
      break;
    case 2:
      if (mask != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      inject_kernel<<<dim3(pfh::blocks_for(nvc + nmc), F), pfh::kThreads, 0, s>>>(
          src_v, dst_v, dst_m, nyc, nxc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
