// Kernel V, vcycle_fused: one V-cycle apply and its exported A z in ONE
// cooperative launch with a thread-block cluster dimension, f32, templated
// on the levels' gather J.v (physics and point count) and, apart, on the
// exported matvec's (the coupled physics at the outer rule).
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_vcycle (:200)
// with with_matvec=True (:399-423), TPU row 5, where the JAX package takes
// it (fuse_vcycle "auto", solve/gmg.py:320-345): bench1 and bench2. One
// launch computes, in the JAX kernel's order:
//
//   1. the descent, levels l = 0 .. K-1: x = 0, r = b_l, n_l sweeps (kernel
//      L's body, lmr_loop.cuh lmr_sweeps), b_{l+1} = P^T r (D's or H's
//      bodies): the phases of vcycle_chain_kernel<..., false>;
//   2. the coarsest level K: x = 0, r = b_K, coarse_sweeps sweeps of L's
//      body (the split apply's zeros, clone and launch of L);
//   3. the ascent, levels K-1 .. 0: x = x_l + P x_{l+1}, r = b_l - J x, n_l
//      sweeps: vcycle_chain_kernel<..., true>; level 0's x is the output z;
//   4. A z on the fine level: the matvec's jvp_node at every fine node (the
//      gather's sum, which kernel W, the split apply's exported J.v,
//      reproduces to the bit).
//
// Scopes: each level's phases run on the whole grid or on cluster 0 (the
// first C CTAs of the launch: a 1D cluster holds consecutive blocks), synced
// by the cluster barrier, its loops striding over the cluster's threads.
// Levels l >= cluster_from take cluster 0, the others the grid (the plan
// fixes cluster_from, ops/vcycle_fused.py). A barrier follows each phase
// that another thread reads: the cluster's between two phases of cluster
// scope, the grid's otherwise; the CTAs outside cluster 0 skip its phases
// and wait at the next grid barrier. Every loop of a level strides over its
// scope's CTAs, the dot slots are kernel C's partition (lmr_partial_blocks),
// and a thread reads with plain loads only the nodes it wrote in the same
// scope after the last barrier (the node loops share one mapping; other
// planes at L2, __ldcg). So the bits are those of the split apply
// (ops/vcycle_fused.py ``.sequence``: descend chain, L, ascend chain, the
// exported J.v), whatever the grid, cluster size and scopes.
//
// The table: 2K + 1 ChainLevel records, as vcycle_chain.cuh packs them: the
// descent's K (each level's pre-sweep count), the coarsest's (R = 0), the
// ascent's K (the post-sweep counts; above level 0 the iterate is updated in
// place), then the matvec's JvpParams with dt; the two records of a level
// share its planes and partials. The host packs it once per multigrid build
// (ops/vcycle_fused.VcyclePlan). Each CTA stages a level's record into
// shared memory, and at step 4 level 0's with the matvec's parameter block
// in place of the level's.
//
// The launch: cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension (C
// <= 16 CTAs; above 8 with cudaFuncAttributeNonPortableClusterSizeAllowed)
// and cudaLaunchAttributeCooperative, so that one launch has both barriers;
// the grid is min(the CTAs any phase can use, rounded up to C; the
// co-resident clusters, cudaOccupancyMaxActiveClusters, times C). A launch
// that cannot be made returns its CUDA error; nothing falls back to the
// split apply.
//
// What bounds it on the H100: the barrier intervals of the coarse levels (a
// few nodes per thread between barriers), then the fine levels' sweeps'
// operations; the bound of the same work is ~1-3 us. The design removes
// three host wrapper calls and five launches per apply, and takes the
// coarsest level's barriers off the grid onto one cluster.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "vcycle_chain.cuh"

namespace pfh {

// The phases one launch runs (a bit each); the main path runs all of them,
// the probes of chip_smoke.py time one alone.
constexpr int kVDescend = 1;
constexpr int kVCoarse = 2;
constexpr int kVAscend = 4;
constexpr int kVMatvec = 8;
constexpr int kVMaxCluster = 16;

// The call's pointers: the fine right-hand side, and the outputs z and A z.
struct FusedIO {
  const float* bv;
  const float* bm;
  float* zv;
  float* zm;
  float* av;
  float* am;
};

// A level's scope (lmr_loop.cuh GridScope's members): the grid, or cluster
// 0; `in` says whether this CTA runs the level's phases.
struct VScope {
  int r, n;
  bool cluster, in;
  __device__ __forceinline__ int rank() const { return r; }
  __device__ __forceinline__ int size() const { return n; }
  __device__ __forceinline__ long first() const {
    return static_cast<long>(r) * blockDim.x + threadIdx.x;
  }
  __device__ __forceinline__ long stride() const {
    return static_cast<long>(n) * blockDim.x;
  }
  __device__ __forceinline__ void sync() const {
    if (!cluster)
      loop_barrier();
    else if (n == 1)
      __syncthreads();
    else
      cooperative_groups::this_cluster().sync();
  }
};

__device__ __forceinline__ VScope grid_scope() {
  return VScope{static_cast<int>(blockIdx.x), static_cast<int>(gridDim.x),
                false, true};
}

__device__ __forceinline__ VScope level_scope(int l, int cluster_from) {
  if (l < cluster_from) return grid_scope();
  const int C =
      static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  const int b = static_cast<int>(blockIdx.x);
  return VScope{b, C, true, b < C};
}

// The barrier after a phase of scope a whose output a phase of scope b reads.
__device__ __forceinline__ void join(const VScope& a, const VScope& b) {
  if (a.cluster && b.cluster) {
    if (a.in) a.sync();
  } else {
    loop_barrier();
  }
}

// x = 0, r = b at the scope's nodes (the descent's and the coarsest's first
// phase, vcycle_chain_kernel's).
template <int NF>
__device__ __forceinline__ void start_level(const ChainLevel& c,
                                            const VScope& s) {
  const LoopArgs& A = c.A;
  const long N = A.nvert + A.ncell;
  for (long idx = s.first(); idx < N; idx += s.stride()) {
    const Node nd(A, idx);
    const float* b = nd.on_v ? c.bv : c.bm;
    float* x = nd.on_v ? A.xv : A.xm;
    float* r = nd.on_v ? A.rv : A.rm;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const long o = nd.at(f);
      x[o] = 0.f;
      r[o] = __ldcg(b + o);
    }
  }
}

template <class Phys, int NQ, class MPhys, int MNQ>
__global__ void __launch_bounds__(kLoopThreads)
vcycle_fused_kernel(const ChainLevel* __restrict__ T,
                    const JvpParams* __restrict__ MV, int K, int cluster_from,
                    int phases, const FusedIO io) {
  using Lv = Level2<Phys, NQ>;
  constexpr int NF = Phys::NF;
  static_assert(MPhys::NF == NF, "the matvec acts on the levels' fields");
  __shared__ LoopShared sh;
  __shared__ ChainLevel cl;
  const ChainIO cio{io.bv, io.bm, nullptr, nullptr, io.zv, io.zm};

  if (phases & kVDescend) {
    for (int l = 0; l < K; ++l) {
      const VScope s = level_scope(l, cluster_from);
      if (s.in) {
        stage_level<false>(T, l, cio, &cl);
        start_level<NF>(cl, s);
        lmr_sweeps<Lv>(cl.P, cl.A, sh, nullptr, s);
        s.sync();
        restrict_level<NF>(cl, s.first(), s.stride());
      }
      join(s, level_scope(l + 1, cluster_from));
    }
  }
  if (phases & kVCoarse) {
    const VScope s = level_scope(K, cluster_from);
    if (s.in) {
      stage_level<false>(T, K, cio, &cl);  // K >= 1: the record's own b
      start_level<NF>(cl, s);
      lmr_sweeps<Lv>(cl.P, cl.A, sh, nullptr, s);
    }
    join(s, level_scope(K - 1, cluster_from));
  }
  if (phases & kVAscend) {
    for (int l = K - 1; l >= 0; --l) {
      const VScope s = level_scope(l, cluster_from);
      if (s.in) {
        stage_level<true>(T + K + 1, l, cio, &cl);
        const LoopArgs& A = cl.A;
        prolong_level<NF>(cl, T[l + 1].A.xv, T[l + 1].A.xm, s.first(),
                          s.stride());
        s.sync();
        const long N = A.nvert + A.ncell;
        for (long idx = s.first(); idx < N; idx += s.stride()) {  // b - J x
          float acc[NF];
          jvp_node<Phys, NQ, LoadCG>(cl.P, A.wv, A.wm, A.xv, A.xm, idx, A.ny,
                                     A.nx, acc);
          jvp_store<NF, LoadCG>(acc, idx, A.nvert, A.ncell, A.xv, cl.bv,
                                cl.bm, A.mask, A.rv, A.rm);
        }
        lmr_sweeps<Lv>(cl.P, A, sh, nullptr, s);
      }
      join(s, l > 0 ? level_scope(l - 1, cluster_from) : grid_scope());
    }
  }
  if (phases & kVMatvec) {  // A z at the fine nodes, by the matvec's rule
    stage_level<false>(T, 0, cio, &cl);
    const int* src = reinterpret_cast<const int*>(MV);
    int* dst = reinterpret_cast<int*>(&cl.P);
    constexpr int kWords = static_cast<int>(sizeof(JvpParams) / sizeof(int));
    for (int i = threadIdx.x; i < kWords; i += blockDim.x) dst[i] = __ldg(src + i);
    __syncthreads();
    const LoopArgs& A = cl.A;
    const long N = A.nvert + A.ncell;
    const VScope g = grid_scope();
    for (long idx = g.first(); idx < N; idx += g.stride()) {
      float acc[NF];
      jvp_node<MPhys, MNQ, LoadCG>(cl.P, A.wv, A.wm, io.zv, io.zm, idx, A.ny,
                                   A.nx, acc);
      jvp_store<NF, LoadCG>(acc, idx, A.nvert, A.ncell, io.zv, nullptr,
                            nullptr, nullptr, io.av, io.am);
    }
  }
}
static_assert(sizeof(JvpParams) % sizeof(int) == 0, "staged as ints");

inline cudaLaunchConfig_t fused_config(int grid, int cluster,
                                       cudaLaunchAttribute* at,
                                       cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kLoopThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return cfg;
}

// The co-resident clusters of C CTAs of one instantiation on the current
// device (cached per device and C), or the CUDA error negated.
template <class Phys, int NQ, class MPhys, int MNQ>
inline int fused_resident_clusters(int C) {
  static int cached[64][kVMaxCluster + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return -static_cast<int>(cudaErrorInvalidDevice);
  if (cached[dev][C] == 0) {
    auto kern = vcycle_fused_kernel<Phys, NQ, MPhys, MNQ>;
    cudaError_t err = cudaSuccess;
    if (C > 8)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaLaunchAttribute at[2];
    cudaLaunchConfig_t cfg = fused_config(C, C, at, nullptr);
    int n = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (err != cudaSuccess) return -static_cast<int>(err);
    cached[dev][C] = n;
  }
  return cached[dev][C];
}

// table: 2K + 1 ChainLevel records, then the matvec's JvpParams, in device
// memory; need: the most CTAs any phase can use (the plan computes it);
// cluster: C; cluster_from: the first level on cluster 0 (K + 1: none);
// phases: kV* bits. *grid_out: the CTAs run.
template <class Phys, int NQ, class MPhys, int MNQ>
int launch_fused(const void* table, int K, long need, int cluster,
                 int cluster_from, int phases, const FusedIO& io,
                 int* grid_out, cudaStream_t s) {
  if (table == nullptr || K < 1 || need < 1 || cluster < 1 ||
      cluster > kVMaxCluster || cluster_from < 1 || cluster_from > K + 1 ||
      io.bv == nullptr || io.zv == nullptr || io.av == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = fused_resident_clusters<Phys, NQ, MPhys, MNQ>(cluster);
  if (n < 0) return -n;
  if (n == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long want = (need + cluster - 1) / cluster;
  const int grid = cluster * static_cast<int>(std::min(want, static_cast<long>(n)));
  *grid_out = grid;
  const ChainLevel* T = static_cast<const ChainLevel*>(table);
  const JvpParams* MV = reinterpret_cast<const JvpParams*>(T + 2 * K + 1);
  cudaLaunchAttribute at[2];
  cudaLaunchConfig_t cfg = fused_config(grid, cluster, at, s);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, vcycle_fused_kernel<Phys, NQ, MPhys, MNQ>, T,
                         MV, K, cluster_from, phases, io);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// One instantiation's launcher: nq and mv_nq, the levels' and the matvec's
// point counts, must be NQ and MNQ (a V of other rules is not built).
template <class Phys, int NQ, class MPhys, int MNQ>
int vcycle_fused(int nq, int mv_nq, const void* table, int K, long need,
                 int cluster, int cluster_from, int phases, const float* bv,
                 const float* bm, float* zv, float* zm, float* av, float* am,
                 int* grid_out, void* stream) {
  if (nq != NQ || mv_nq != MNQ) return static_cast<int>(cudaErrorInvalidValue);
  const FusedIO io{bv, bm, zv, zm, av, am};
  return launch_fused<Phys, NQ, MPhys, MNQ>(
      table, K, need, cluster, cluster_from, phases, io, grid_out,
      static_cast<cudaStream_t>(stream));
}

// Registers, spills, shared bytes and CTAs per SM (common.cuh kernel_info),
// then out[5] the co-resident clusters of `cluster` CTAs.
template <class Phys, int NQ, class MPhys, int MNQ>
int vcycle_fused_info(int cluster, int* out) {
  if (cluster < 1 || cluster > kVMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = kernel_info(vcycle_fused_kernel<Phys, NQ, MPhys, MNQ>,
                              kLoopThreads, 0, out);
  if (err != 0) return err;
  const int n = fused_resident_clusters<Phys, NQ, MPhys, MNQ>(cluster);
  if (n < 0) return -n;
  out[5] = n;
  return 0;
}

}  // namespace pfh
