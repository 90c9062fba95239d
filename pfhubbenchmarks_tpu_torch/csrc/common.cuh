// Shared declarations of the port's hand-written Hopper kernels.
//
// Every kernel launches on the stream it is given (PyTorch's current
// stream), allocates nothing, and its host launcher returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch. The launchers have a plain C interface and are bound with ctypes
// (pfhubbenchmarks_tpu_torch/ops/_lib.py).
#pragma once

#include <cuda_runtime.h>

#define PFH_EXPORT extern "C" __attribute__((visibility("default")))

namespace pfh {

constexpr int kThreads = 128;

inline int blocks_for(long n, int threads = kThreads) {
  return static_cast<int>((n + threads - 1) / threads);
}

// Contiguous field groups of a field-split operator (SolverConfig.
// field_split): group g holds fields start[g] .. start[g+1]-1. No groups is
// the single group {0, F}. Passed by value, so the kernels index it in the
// parameter space.
constexpr int kMaxGroups = 8;

struct FieldGroups {
  int n;
  int start[kMaxGroups + 1];
};

// Host side: the groups from n starts (start[n] == F), or nullptr for one
// group of all F fields. Returns false if they are not a valid partition.
inline bool make_groups(int F, int n, const int* starts, FieldGroups* out) {
  if (starts == nullptr) {
    out->n = 1;
    out->start[0] = 0;
    out->start[1] = F;
    return F > 0;
  }
  if (n < 1 || n > kMaxGroups || starts[0] != 0 || starts[n] != F) return false;
  out->n = n;
  for (int g = 0; g <= n; ++g) {
    if (g > 0 && starts[g] <= starts[g - 1]) return false;
    out->start[g] = starts[g];
  }
  return true;
}

// How a gather reads a plane: LoadRO through the read-only cache, for a
// plane no thread writes during the launch; LoadCG at L2, for one that other
// blocks wrote earlier in the same launch (kernel L's z, lmr_loop.cuh), which
// the read-only path may not see.
struct LoadRO {
  __device__ __forceinline__ static float ld(const float* p) { return __ldg(p); }
};
struct LoadCG {
  __device__ __forceinline__ static float ld(const float* p) { return __ldcg(p); }
};

// What the compiler and the occupancy calculator give for kernel k launched
// with `threads` threads and `smem` dynamic shared bytes: out[0] registers
// per thread, out[1] local (spill and stack) bytes per thread, out[2] static
// shared bytes, out[3] the dynamic shared bytes, out[4] co-resident CTAs per
// SM. For the probes and chip_smoke.py; no launch reads it.
template <class Kernel>
inline int kernel_info(Kernel* k, int threads, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(k));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = smem;
  out[4] = per_sm;
  return 0;
}

// The group of field f.
__device__ __forceinline__ int group_of(const FieldGroups& G, int f) {
  int g = 0;
  while (g + 1 < G.n && f >= G.start[g + 1]) ++g;
  return g;
}

}  // namespace pfh
