// Kernels vcycle_descend_chain and vcycle_ascend_chain: the descent and the
// ascent of a V-cycle over all of a chain's levels, each in ONE persistent
// cooperative launch, f32, templated on the levels' gather J.v (physics and
// point count: every level of a chain runs the same rule).
//
// Replace pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_descend_chain
// (:652) and make_fused_ascend_chain (:798), and with one level their steps
// make_fused_descend (:566) and make_fused_ascend (:939). Per level l, the
// descent (l = 0 .. K-1):
//
//   1. x = 0, r = b_l            (b_0 the call's; b_l, l > 0, restricted below)
//   2. n_l LMR sweeps on (x, r)  kernel L's body (lmr_loop.cuh lmr_sweeps)
//   3. b_{l+1} = P^T r, 0 on the coarse Dirichlet rows: kernel D's per-node
//      bodies for a dyadic pair, H's for an equal odd ratio R (transfer.cuh)
//
// and the ascent (l = K-1 .. 0):
//
//   1. x = x_l + P xc            (xc the call's at K-1, else level l+1's x);
//                                nothing added on the fine Dirichlet rows
//   2. r = b_l - J x             the level J.v's body and epilogue
//                                (fem_jvp.cuh jvp_node, jvp_store)
//   3. n_l LMR sweeps on (x, r)  L's body; level 0's x is the call's output
//
// with a grid barrier after each phase that another thread reads. The
// bodies are the ones kernels L, D, H and the J.v run, unchanged, and every
// loop is grid-stride with L's slot partition, so the bits are those of the
// launch sequence L, D or H, J.v (ops/vcycle_chain.py ``.sequence``) whatever
// the grid.
//
// The levels: a device table of ChainLevel records (the level J.v's
// parameter block with its dt, H's class tables, the sweeps' LoopArgs, the
// pair), packed on the host once per multigrid build (pfh_vcycle_chain_pack)
// and owned by the chain's plan, as are every level's scratch (r, z, A z,
// the f64 partials) and the descent's outputs. At each level every CTA
// stages the level's record into shared memory, so the sweeps and the J.v
// read their parameters there (a record is ~3.8 KB: three levels would pass
// the 4 KB of a classic kernel-parameter block). The call's own pointers
// (level 0's right-hand side, the coarsest correction, the output) are
// kernel parameters.
//
// Memory: planes written earlier in the launch (r, x, the restricted
// right-hand side, the prolonged x, z and A z) are read at L2 (__ldcg, the
// LoadCG policy) wherever another thread wrote them; a thread reads its own
// nodes' r and x with plain loads only where it wrote them itself (the node
// loops share one mapping). The state, P^-1, the masks and the table are
// read-only.
//
// One grid for levels of very different sizes: min(the most CTAs any phase
// of any level can use, the co-resident CTAs of the instantiation); the
// small levels then pay their barriers over idle CTAs. A launch that cannot
// be made returns its CUDA error; nothing falls back to the launch sequence.
//
// What bounds it on the H100: at the fine levels the sweeps' operations (L's
// bound); the per-launch host path and the launches of the sequence it
// replaces (a chain of K levels is 2K or 3K launches of L, D or H and the
// J.v) are what the design removes; it adds a barrier per transfer.
#pragma once

#include "lmr_loop.cuh"
#include "transfer.cuh"

namespace pfh {

// One level of a chain; the pair is (this level, level l + 1).
struct ChainLevel {
  JvpParams P;         // the level J.v's parameter block, dt included
  xfer::GenWeights W;  // the pair's class tables (odd R), else zeros
  LoopArgs A;          // the sweeps' operands (level 0's ascent x: the call's)
  const float* bv;     // the right-hand side (level 0: the call's)
  const float* bm;
  const float* xv;     // the ascent: the descent's iterate of this level
  const float* xm;
  float* tv;           // the descent: the restricted right-hand side
  float* tm;
  const float* tmask;  // the transfer's Dirichlet mask (its output grid)
  int R;               // the pair's ratio: 2 (D's bodies), 3, 5 or 7 (H's)
  int nyc, nxc;        // the coarse grid's cells
};

// The call's pointers: level 0's right-hand side; for the ascent the
// coarsest correction and the output (level 0's x).
struct ChainIO {
  const float* bv;
  const float* bm;
  const float* xcv;
  const float* xcm;
  float* zv;
  float* zm;
};

// Level l's record into shared memory, by the whole CTA; the call's
// pointers in place of level 0's.
template <bool ASC>
__device__ __forceinline__ void stage_level(const ChainLevel* __restrict__ T,
                                            int l, const ChainIO& io,
                                            ChainLevel* cl) {
  const int* src = reinterpret_cast<const int*>(T + l);
  int* dst = reinterpret_cast<int*>(cl);
  constexpr int kWords = static_cast<int>(sizeof(ChainLevel) / sizeof(int));
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) dst[i] = __ldg(src + i);
  __syncthreads();
  if (l == 0 && threadIdx.x == 0) {
    cl->bv = io.bv;
    cl->bm = io.bm;
    if (ASC) {
      cl->A.xv = io.zv;
      cl->A.xm = io.zm;
    }
  }
  __syncthreads();
}
static_assert(sizeof(ChainLevel) % sizeof(int) == 0, "staged as ints");

// H's restriction at one coarse vertex or centre, from fine planes in
// device memory.
template <int R>
__device__ __forceinline__ float general_restrict_at(
    const xfer::GenWeights& W, const float* v, const float* m, bool vert,
    int I, int J, int nyc, int nxc) {
  const xfer::LdPlane<LoadCG> pv{v, R * nxc + 1}, pm{m, R * nxc};
  return vert ? xfer::general_restrict_vertex<R>(W, pv, pm, I, J, nyc, nxc)
              : xfer::general_restrict_centre<R>(W, pv, pm, I, J);
}

// The descent's phase 3: b_{l+1} = P^T r into (tv, tm), one (field, coarse
// node) per thread, grid-stride, as kernels D and H compute each.
template <int NF>
__device__ __forceinline__ void restrict_level(const ChainLevel& c, long first,
                                               long stride) {
  const int nyc = c.nyc, nxc = c.nxc;
  const long nvc = static_cast<long>(nyc + 1) * (nxc + 1);
  const long nmc = static_cast<long>(nyc) * nxc;
  const long per = nvc + nmc;
  for (long t = first; t < NF * per; t += stride) {
    const int f = static_cast<int>(t / per);
    const long idx = t - f * per;
    const float* v = c.A.rv + f * c.A.nvert;
    const float* m = c.A.rm + f * c.A.ncell;
    const bool vert = idx < nvc;
    const long k = vert ? idx : idx - nvc;
    const int I = static_cast<int>(vert ? k / (nxc + 1) : k / nxc);
    const int J = static_cast<int>(vert ? k % (nxc + 1) : k % nxc);
    float acc;
    switch (c.R) {
      case 2:
        acc = vert ? xfer::dyadic_restrict_vertex<LoadCG>(v, m, I, J, nyc, nxc)
                   : xfer::dyadic_restrict_centre<LoadCG>(v, m, I, J, nxc);
        break;
      case 3:
        acc = general_restrict_at<3>(c.W, v, m, vert, I, J, nyc, nxc);
        break;
      case 5:
        acc = general_restrict_at<5>(c.W, v, m, vert, I, J, nyc, nxc);
        break;
      default:
        acc = general_restrict_at<7>(c.W, v, m, vert, I, J, nyc, nxc);
        break;
    }
    if (vert) {
      if (c.tmask != nullptr && __ldg(c.tmask + f * nvc + idx) != 0.f) acc = 0.f;
      c.tv[f * nvc + idx] = acc;
    } else {
      c.tm[f * nmc + k] = acc;
    }
  }
}

// The ascent's phase 1: x = x_l + P xc, one (field, fine node) per thread,
// grid-stride; on a fine Dirichlet row the prolonged value is 0, as kernels
// D and H accumulate it.
template <int NF>
__device__ __forceinline__ void prolong_level(const ChainLevel& c,
                                              const float* xcv,
                                              const float* xcm, long first,
                                              long stride) {
  const int nyc = c.nyc, nxc = c.nxc;
  const int nxf = c.A.nx, nvxf = nxf + 1;
  const long nvf = c.A.nvert, nmf = c.A.ncell;
  const long nvc = static_cast<long>(nyc + 1) * (nxc + 1);
  const long nmc = static_cast<long>(nyc) * nxc;
  const long per = nvf + nmf;
  for (long t = first; t < NF * per; t += stride) {
    const int f = static_cast<int>(t / per);
    const long idx = t - f * per;
    const float* v = xcv + f * nvc;
    const float* m = xcm + f * nmc;
    const bool vert = idx < nvf;
    const long k = vert ? idx : idx - nvf;
    const int Y = static_cast<int>(vert ? k / nvxf : k / nxf);
    const int X = static_cast<int>(vert ? k % nvxf : k % nxf);
    float val;
    switch (c.R) {
      case 2:
        val = vert ? xfer::dyadic_prolong_vertex<LoadCG>(v, m, Y, X, nxc)
                   : xfer::dyadic_prolong_centre<LoadCG>(v, m, Y, X, nxc);
        break;
      case 3:
        val = xfer::general_prolong_node<3, LoadCG>(c.W, v, m, vert, Y, X, nyc, nxc);
        break;
      case 5:
        val = xfer::general_prolong_node<5, LoadCG>(c.W, v, m, vert, Y, X, nyc, nxc);
        break;
      default:
        val = xfer::general_prolong_node<7, LoadCG>(c.W, v, m, vert, Y, X, nyc, nxc);
        break;
    }
    if (vert && c.tmask != nullptr && __ldg(c.tmask + f * nvf + k) != 0.f)
      val = 0.f;
    const long o = f * (vert ? nvf : nmf) + k;
    const float* xin = vert ? c.xv : c.xm;
    float* x = vert ? c.A.xv : c.A.xm;
    // D adds as written, H one rounded add (transfer.cu, transfer_general.cu)
    x[o] = c.R == 2 ? __ldcg(xin + o) + val : xfer::add(__ldcg(xin + o), val);
  }
}

template <class Phys, int NQ, bool ASC>
__global__ void __launch_bounds__(kLoopThreads)
vcycle_chain_kernel(const ChainLevel* __restrict__ T, int K, const ChainIO io) {
  using Lv = Level2<Phys, NQ>;
  constexpr int NF = Phys::NF;
  __shared__ LoopShared sh;
  __shared__ ChainLevel cl;
  const long first = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;

  for (int s = 0; s < K; ++s) {
    const int l = ASC ? K - 1 - s : s;
    stage_level<ASC>(T, l, io, &cl);
    const LoopArgs& A = cl.A;
    const long N = A.nvert + A.ncell;
    if (ASC) {
      const float* xcv = l + 1 == K ? io.xcv : T[l + 1].A.xv;
      const float* xcm = l + 1 == K ? io.xcm : T[l + 1].A.xm;
      prolong_level<NF>(cl, xcv, xcm, first, stride);
      loop_barrier();
      for (long idx = first; idx < N; idx += stride) {  // r = b - J x
        float acc[NF];
        jvp_node<Phys, NQ, LoadCG>(cl.P, A.wv, A.wm, A.xv, A.xm, idx, A.ny,
                                   A.nx, acc);
        jvp_store<NF, LoadCG>(acc, idx, A.nvert, A.ncell, A.xv, cl.bv, cl.bm,
                              A.mask, A.rv, A.rm);
      }
      lmr_sweeps<Lv>(cl.P, A, sh, nullptr);
      if (l > 0) loop_barrier();
    } else {
      for (long idx = first; idx < N; idx += stride) {  // x = 0, r = b
        const Node nd(A, idx);
        const float* b = nd.on_v ? cl.bv : cl.bm;
        float* x = nd.on_v ? A.xv : A.xm;
        float* r = nd.on_v ? A.rv : A.rm;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          const long o = nd.at(f);
          x[o] = 0.f;
          r[o] = __ldcg(b + o);
        }
      }
      lmr_sweeps<Lv>(cl.P, A, sh, nullptr);
      loop_barrier();
      restrict_level<NF>(cl, first, stride);
      if (l + 1 < K) loop_barrier();
    }
  }
}

template <class Phys, int NQ, bool ASC>
inline int chain_resident_ctas() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, vcycle_chain_kernel<Phys, NQ, ASC>, kLoopThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

// need: the most CTAs any phase of any level can use (the host computes it
// from the levels' sizes); the grid is min(need, co-resident CTAs), or one
// CTA synced by __syncthreads where that is 1. *grid_out: the CTAs run.
template <class Phys, int NQ, bool ASC>
int launch_chain(const ChainLevel* T, int K, long need, const ChainIO& io,
                 int* grid_out, cudaStream_t s) {
  if (T == nullptr || K < 1 || need < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int resident = chain_resident_ctas<Phys, NQ, ASC>();
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = static_cast<int>(std::min(need, static_cast<long>(resident)));
  *grid_out = grid;
  if (grid == 1) {
    vcycle_chain_kernel<Phys, NQ, ASC><<<1, kLoopThreads, 0, s>>>(T, K, io);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {const_cast<ChainLevel**>(&T), &K,
                  const_cast<ChainIO*>(&io)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)vcycle_chain_kernel<Phys, NQ, ASC>, dim3(grid),
      dim3(kLoopThreads), args, 0, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The direction and point-count dispatch of one physics (rules of 1, 3 or 4
// points). table: K ChainLevel records in device memory.
template <class Phys>
int vcycle_chain(int ascend, int nq, const void* table, int K, long need,
                 const float* bv, const float* bm, const float* xcv,
                 const float* xcm, float* zv, float* zm, int* grid_out,
                 void* stream) {
  const ChainLevel* T = static_cast<const ChainLevel*>(table);
  const ChainIO io{bv, bm, xcv, xcm, zv, zm};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ascend && (xcv == nullptr || zv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define PFH_CHAIN_NQ(Q)                                                      \
  case Q:                                                                    \
    return ascend ? launch_chain<Phys, Q, true>(T, K, need, io, grid_out, s) \
                  : launch_chain<Phys, Q, false>(T, K, need, io, grid_out, s);
  switch (nq) {
    PFH_CHAIN_NQ(1)
    PFH_CHAIN_NQ(3)
    PFH_CHAIN_NQ(4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PFH_CHAIN_NQ
}

// Registers, spills, shared bytes and co-resident CTAs per SM of one
// instantiation (common.cuh kernel_info).
template <class Phys>
int vcycle_chain_info(int ascend, int nq, int* out) {
#define PFH_CHAIN_INFO(Q)                                                      \
  case Q:                                                                      \
    return ascend ? kernel_info(vcycle_chain_kernel<Phys, Q, true>,            \
                                kLoopThreads, 0, out)                          \
                  : kernel_info(vcycle_chain_kernel<Phys, Q, false>,           \
                                kLoopThreads, 0, out);
  switch (nq) {
    PFH_CHAIN_INFO(1)
    PFH_CHAIN_INFO(3)
    PFH_CHAIN_INFO(4)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PFH_CHAIN_INFO
}

}  // namespace pfh
