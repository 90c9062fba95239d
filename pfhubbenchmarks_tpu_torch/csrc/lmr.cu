// Kernel C, lmr_step: one local-minimal-residual update, in place, f32.
//
//   alpha = <Az, r> / <Az, Az>   (0 when <Az, Az> == 0)
//   x += alpha z,   r -= alpha Az
//
// over the v and m planes together. Replaces _lmr_alpha and the axpys of
// the LMR sweep body in pfhubbenchmarks_tpu/ops/pallas_vcycle.py
// (make_fused_vcycle's sweeps, :311-325 and :503-517).
//
// Design: a deterministic two-stage reduction. Stage 1 (lmr_partials): a
// fixed number of blocks, chosen from the vector length alone, each
// reduces a fixed strided subset into two double partials with a fixed
// shared-memory tree. Stage 2 (lmr_update): thread 0 of every block sums the
// partials in index order and forms alpha (so every block computes the
// same alpha), then the block applies the two axpys. No atomics: the same
// inputs give the same bits on every run. alpha stays in device memory
// (also written to alpha_out for inspection) and never goes to the host.
//
// What bounds it on the H100: ~0.3 MB read and 0.3 MB written per step at
// 100^2, L2-resident; the step is two launches of latency, which the
// design accepts in exchange for determinism without a grid-wide sync.

#include "common.cuh"

namespace {

constexpr int kRedThreads = 256;

__device__ __forceinline__ float at(const float* a, const float* b, long nv, long i) {
  return i < nv ? __ldg(a + i) : __ldg(b + (i - nv));
}

__global__ void __launch_bounds__(kRedThreads)
lmr_partials_kernel(const float* __restrict__ azv, const float* __restrict__ azm,
                    const float* __restrict__ rv, const float* __restrict__ rm,
                    long nv, long nm, double* __restrict__ partials) {
  __shared__ double s_num[kRedThreads];
  __shared__ double s_den[kRedThreads];
  const long n = nv + nm;
  double num = 0.0, den = 0.0;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const double a = at(azv, azm, nv, i);
    num += a * at(rv, rm, nv, i);
    den += a * a;
  }
  s_num[threadIdx.x] = num;
  s_den[threadIdx.x] = den;
  __syncthreads();
  for (int stride = kRedThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_num[threadIdx.x] += s_num[threadIdx.x + stride];
      s_den[threadIdx.x] += s_den[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s_num[0];
    partials[gridDim.x + blockIdx.x] = s_den[0];
  }
}

__global__ void __launch_bounds__(pfh::kThreads)
lmr_update_kernel(const double* __restrict__ partials, int nb,
                  float* __restrict__ xv, float* __restrict__ xm,
                  float* __restrict__ rv, float* __restrict__ rm,
                  const float* __restrict__ zv, const float* __restrict__ zm,
                  const float* __restrict__ azv, const float* __restrict__ azm,
                  long nv, long nm, float* __restrict__ alpha_out) {
  __shared__ float s_alpha;
  if (threadIdx.x == 0) {
    double num = 0.0, den = 0.0;
    for (int b = 0; b < nb; ++b) {
      num += partials[b];
      den += partials[nb + b];
    }
    s_alpha = den > 0.0 ? static_cast<float>(num / den) : 0.0f;
    if (blockIdx.x == 0) alpha_out[0] = s_alpha;
  }
  __syncthreads();
  const float alpha = s_alpha;
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < nv) {
    xv[i] += alpha * zv[i];
    rv[i] -= alpha * azv[i];
  } else if (i < nv + nm) {
    const long j = i - nv;
    xm[j] += alpha * zm[j];
    rm[j] -= alpha * azm[j];
  }
}

}  // namespace

// partials: device scratch of 2 * nb doubles, nb in [1, 64]; alpha_out: one
// device float.
PFH_EXPORT int pfh_lmr_step(float* xv, float* xm, float* rv, float* rm,
                            const float* zv, const float* zm, const float* azv,
                            const float* azm, long nv, long nm, double* partials,
                            int nb, float* alpha_out, void* stream) {
  if (nb < 1 || nb > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lmr_partials_kernel<<<nb, kRedThreads, 0, s>>>(azv, azm, rv, rm, nv, nm, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lmr_update_kernel<<<pfh::blocks_for(nv + nm), pfh::kThreads, 0, s>>>(
      partials, nb, xv, xm, rv, rm, zv, zm, azv, azm, nv, nm, alpha_out);
  return static_cast<int>(cudaGetLastError());
}
