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
// Design: every output node gathers its inputs, one thread per node with a
// loop over fields. Restriction is written as a gather per coarse node over
// its fine neighbourhood (no scatter, no atomics), each term added in the
// order of solve/transfer.py:restrict. Prolongation can accumulate into its
// output (x += P xc, the coarse-grid correction) to save a launch.
//
// Dirichlet rows (BM6's phi edges): an optional 0/1 vertex mask of the
// OUTPUT grid, [F, Yv, Xv] floats. Restriction writes 0 on the coarse BC
// rows, and prolongation leaves the fine BC rows untouched when it
// accumulates (writes 0 there otherwise). This is zero_bc_rows of
// pfhubbenchmarks_tpu/solve/gmg.py:633-648 and the keep masks of
// ops/pallas_vcycle.py:make_fused_descend_chain / make_fused_ascend_chain.
//
// What bounds it on the H100: a few hundred KB per call at BM1's 100^2 and
// 50^2, L2-resident: launch latency. One launch per transfer.

#include "common.cuh"

namespace {

// fine v [F, 2nyc+1, 2nxc+1], fine m [F, 2nyc, 2nxc] from coarse v, m
__global__ void __launch_bounds__(pfh::kThreads)
prolong_kernel(const float* __restrict__ vc, const float* __restrict__ mc,
               float* __restrict__ vf, float* __restrict__ mf,
               const float* __restrict__ mask, int F, int nyc, int nxc,
               int accumulate) {
  const int nvxc = nxc + 1;
  const long nvc = static_cast<long>(nyc + 1) * nvxc;
  const long nmc = static_cast<long>(nyc) * nxc;
  const int nvxf = 2 * nxc + 1, nxf = 2 * nxc;
  const long nvf = static_cast<long>(2 * nyc + 1) * nvxf;
  const long nmf = static_cast<long>(2 * nyc) * nxf;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvf + nmf) return;
  for (int f = 0; f < F; ++f) {
    const float* v = vc + f * nvc;
    const float* m = mc + f * nmc;
    float val;
    float* out;
    if (idx < nvf) {
      const int Y = static_cast<int>(idx / nvxf), X = static_cast<int>(idx % nvxf);
      const int i = Y >> 1, j = X >> 1;
      if (!(Y & 1) && !(X & 1)) {
        val = __ldg(v + i * nvxc + j);
      } else if (!(Y & 1)) {
        val = 0.5f * (__ldg(v + i * nvxc + j) + __ldg(v + i * nvxc + j + 1));
      } else if (!(X & 1)) {
        val = 0.5f * (__ldg(v + i * nvxc + j) + __ldg(v + (i + 1) * nvxc + j));
      } else {
        val = __ldg(m + i * nxc + j);
      }
      if (mask != nullptr && __ldg(mask + f * nvf + idx) != 0.f) val = 0.f;
      out = vf + f * nvf + idx;
    } else {
      const long c = idx - nvf;
      const int y = static_cast<int>(c / nxf), x = static_cast<int>(c % nxf);
      const int i = y >> 1, j = x >> 1;
      val = 0.5f * (__ldg(v + (i + (y & 1)) * nvxc + j + (x & 1)) + __ldg(m + i * nxc + j));
      out = mf + f * nmf + c;
    }
    *out = accumulate ? *out + val : val;
  }
}

// coarse = P^T fine
__global__ void __launch_bounds__(pfh::kThreads)
restrict_kernel(const float* __restrict__ vf, const float* __restrict__ mf,
                float* __restrict__ vc, float* __restrict__ mc,
                const float* __restrict__ mask, int F, int nyc, int nxc) {
  const int nvxc = nxc + 1;
  const long nvc = static_cast<long>(nyc + 1) * nvxc;
  const long nmc = static_cast<long>(nyc) * nxc;
  const int nvxf = 2 * nxc + 1, nxf = 2 * nxc;
  const long nvf = static_cast<long>(2 * nyc + 1) * nvxf;
  const long nmf = static_cast<long>(2 * nyc) * nxf;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvc + nmc) return;
  for (int f = 0; f < F; ++f) {
    const float* v = vf + f * nvf;
    const float* m = mf + f * nmf;
    if (idx < nvc) {
      const int I = static_cast<int>(idx / nvxc), J = static_cast<int>(idx % nvxc);
      const int Y = 2 * I, X = 2 * J;
      float acc = __ldg(v + Y * nvxf + X);
      if (J < nxc) acc += 0.5f * __ldg(v + Y * nvxf + X + 1);
      if (J > 0) acc += 0.5f * __ldg(v + Y * nvxf + X - 1);
      if (I < nyc) acc += 0.5f * __ldg(v + (Y + 1) * nvxf + X);
      if (I > 0) acc += 0.5f * __ldg(v + (Y - 1) * nvxf + X);
      if (I < nyc && J < nxc) acc += 0.5f * __ldg(m + Y * nxf + X);
      if (I < nyc && J > 0) acc += 0.5f * __ldg(m + Y * nxf + X - 1);
      if (I > 0 && J < nxc) acc += 0.5f * __ldg(m + (Y - 1) * nxf + X);
      if (I > 0 && J > 0) acc += 0.5f * __ldg(m + (Y - 1) * nxf + X - 1);
      if (mask != nullptr && __ldg(mask + f * nvc + idx) != 0.f) acc = 0.f;
      vc[f * nvc + idx] = acc;
    } else {
      const long c = idx - nvc;
      const int i = static_cast<int>(c / nxc), j = static_cast<int>(c % nxc);
      const int y = 2 * i, x = 2 * j;
      const float sum4 = __ldg(m + y * nxf + x) + __ldg(m + y * nxf + x + 1)
                         + __ldg(m + (y + 1) * nxf + x) + __ldg(m + (y + 1) * nxf + x + 1);
      mc[f * nmc + c] = __ldg(v + (y + 1) * nvxf + x + 1) + 0.5f * sum4;
    }
  }
}

// coarse nodes are fine nodes: coarse vertex (I, J) = fine vertex (2I, 2J),
// coarse centre (i, j) = fine vertex (2i+1, 2j+1)
__global__ void __launch_bounds__(pfh::kThreads)
inject_kernel(const float* __restrict__ vf, float* __restrict__ vc,
              float* __restrict__ mc, int F, int nyc, int nxc) {
  const int nvxc = nxc + 1;
  const long nvc = static_cast<long>(nyc + 1) * nvxc;
  const long nmc = static_cast<long>(nyc) * nxc;
  const int nvxf = 2 * nxc + 1;
  const long nvf = static_cast<long>(2 * nyc + 1) * nvxf;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvc + nmc) return;
  for (int f = 0; f < F; ++f) {
    const float* v = vf + f * nvf;
    if (idx < nvc) {
      const int I = static_cast<int>(idx / nvxc), J = static_cast<int>(idx % nvxc);
      vc[f * nvc + idx] = __ldg(v + (2 * I) * nvxf + 2 * J);
    } else {
      const long c = idx - nvc;
      const int i = static_cast<int>(c / nxc), j = static_cast<int>(c % nxc);
      mc[f * nmc + c] = __ldg(v + (2 * i + 1) * nvxf + 2 * j + 1);
    }
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
  switch (op) {
    case 0:
      prolong_kernel<<<pfh::blocks_for(nvf + nmf), pfh::kThreads, 0, s>>>(
          src_v, src_m, dst_v, dst_m, mask, F, nyc, nxc, accumulate);
      break;
    case 1:
      restrict_kernel<<<pfh::blocks_for(nvc + nmc), pfh::kThreads, 0, s>>>(
          src_v, src_m, dst_v, dst_m, mask, F, nyc, nxc);
      break;
    case 2:
      if (mask != nullptr) return static_cast<int>(cudaErrorInvalidValue);
      inject_kernel<<<pfh::blocks_for(nvc + nmc), pfh::kThreads, 0, s>>>(
          src_v, dst_v, dst_m, F, nyc, nxc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
