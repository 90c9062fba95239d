// Kernel P, fma_chain: the FMA-ladder probe, asked of this card.
//
// Replaces the Pallas kernel of tools/probes/lanefill_probe.py (its
// pallas_call at :55, the kernel body at :41-47), which asked whether the
// TPU's deep FMA ladders are bound by the vector unit's throughput or by
// each operation's latency. For f32 x and y of n elements, one thread per
// element runs DEPTH steps of
//
//   a = a * (1 + a * 1e-12) + y * c_i,   c_i = f32(1e-8 * (i % 5 + 1)),
//
// from a = x, and writes a. The recurrence is quadratic in a, so no compiler
// can collapse the chain (an affine chain folds into one FMA: the TPU
// probe's first version was folded, lanefill_probe.py:44-46). DEPTH is a
// template parameter and the loop is unrolled: the chain is straight-line
// code, two dependent FMAs per step (fma(a, 1e-12, 1) then fma(a, t, y c_i),
// the five products y c_i formed once). nvcc contracts to FMA by default,
// so the bits may differ from the plain version's, which rounds each
// product: by at most one f32 ulp of a per step.
//
// What bounds it on the H100: operations. 4 f32 operations per step and
// 12 bytes per element, so at depth 200 some 67 operations per byte against
// the card's 20 (67 TFLOP/s over 3.35 TB/s). Whether the FMA rate or the
// FMA latency sets the time depends on the thread count: each warp waits
// ~4 cycles for the previous FMA of its chain, so an SM's four schedulers
// need about four resident warps each to issue an FMA every cycle. That is
// the probe's question, asked at kernel I's launch of one thread per vertex
// (132,651 at 50^3, 17,576 at 25^3) and at the TPU probe's four shapes.
// Its design is the question's: nothing but the chain, 128 threads a block
// (csrc/common.cuh, the block of kernel I), one launch.

#include "common.cuh"

namespace {

template <int DEPTH>
__global__ void __launch_bounds__(pfh::kThreads)
fma_chain_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, long n) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = x[i];
  const float b = y[i];
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    const float c = static_cast<float>(1e-8 * (k % 5 + 1));
    a = a * (1.0f + a * 1e-12f) + b * c;
  }
  out[i] = a;
}

template <int DEPTH>
cudaError_t launch(const float* x, const float* y, float* out, long n,
                   cudaStream_t stream) {
  fma_chain_kernel<DEPTH><<<pfh::blocks_for(n), pfh::kThreads, 0, stream>>>(
      x, y, out, n);
  return cudaGetLastError();
}

}  // namespace

// The depths built: ops/fma_chain.py DEPTHS.
PFH_EXPORT int pfh_fma_chain(const float* x, const float* y, float* out,
                             long n, int depth, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 25: return launch<25>(x, y, out, n, s);
    case 50: return launch<50>(x, y, out, n, s);
    case 100: return launch<100>(x, y, out, n, s);
    case 200: return launch<200>(x, y, out, n, s);
    case 400: return launch<400>(x, y, out, n, s);
    case 800: return launch<800>(x, y, out, n, s);
    default: return cudaErrorInvalidValue;
  }
}
