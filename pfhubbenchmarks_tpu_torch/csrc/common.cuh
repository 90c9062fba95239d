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

}  // namespace pfh
