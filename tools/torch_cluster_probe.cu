// The barrier probe of tools/torch_cluster_probe.py: whether the runtime
// takes a cooperative launch with a thread-block cluster dimension, how many
// clusters of C CTAs are co-resident, and what one grid barrier
// (cooperative_groups::this_grid().sync()) and one cluster barrier
// (this_cluster().sync(), cluster 0 only) cost on this card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#define PROBE_EXPORT extern "C" __attribute__((visibility("default")))

namespace cg = cooperative_groups;

// n_grid grid barriers, then n_cluster cluster barriers on cluster 0 (the
// other clusters go straight to the last grid barrier); sink keeps each
// interval's write.
__global__ void __launch_bounds__(256) barrier_probe(int n_grid, int n_cluster,
                                                     float* sink) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < n_grid; ++k) {
    sink[i] += 1.f;
    grid.sync();
  }
  if (blockIdx.x < cluster.num_blocks()) {
    for (int k = 0; k < n_cluster; ++k) {
      sink[i] += 1.f;
      cluster.sync();
    }
  }
  grid.sync();
}

static cudaLaunchConfig_t config(int grid, int cluster, int coop, int smem,
                                 cudaLaunchAttribute* at, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = coop;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return cfg;
}

static int allow(int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      barrier_probe, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaFuncSetAttribute(
      barrier_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// The co-resident clusters of `cluster` CTAs with `smem` dynamic shared bytes
// per CTA (120 KB holds one CTA per SM, as a kernel of > 128 registers).
PROBE_EXPORT int probe_max_clusters(int cluster, int smem, int* out) {
  int err = allow(smem);
  if (err != 0) return err;
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg = config(cluster, cluster, 1, smem, at, 0);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, barrier_probe, &cfg));
}

PROBE_EXPORT int probe_launch(int grid, int cluster, int coop, int smem,
                              int n_grid, int n_cluster, float* sink,
                              void* stream) {
  int err = allow(smem);
  if (err != 0) return err;
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg = config(grid, cluster, coop, smem, at,
                                  static_cast<cudaStream_t>(stream));
  cudaError_t e = cudaLaunchKernelEx(&cfg, barrier_probe, n_grid, n_cluster,
                                     sink);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
