// Kernel L, lmr_sweep: n LMR sweeps of one multigrid level in ONE launch,
// f32, templated on the level's gather J.v (physics and point count).
//
// Replaces pfhubbenchmarks_tpu/ops/pallas_residual.py:
// make_pallas_lmr_sweep_loop (:247, n sweeps in one Pallas call) and
// make_pallas_lmr_sweep (:333), ops/pallas_tiled.py:make_tiled_lmr_sweep
// (:189), and in 3D ops/pallas3d.py:make_pallas_lmr_sweep_loop3d (:182) and
// make_tiled_lmr_sweep3d (:347), on every gather level. One sweep is
//
//   1. z = P^-1 r            per node, the in-group planes only (kernel B's
//                            body, block_jacobi.cu)
//   2. A z                   the level J.v's body: in 2D per node, the
//                            gather (fem_jvp.cuh jvp_node; a Dirichlet row,
//                            mask != 0, gives z); in 3D per box, kernel U's
//                            (fem_tet_tile.cuh tet_box), the boxes
//                            grid-stride over the CTAs, with U's dynamic
//                            shared memory
//   3. <Az, r>_g, <Az, Az>_g C's stage-1 partials in f64 (lmr.cu), slot by
//                            slot
//   4. alpha_g, x += alpha_g z, r -= alpha_g Az (C's stage 2), and the next
//                            sweep's z from the node's new r (its phase 1)
//
// with a barrier after phases 1, 2 and 3: 3 per sweep. Phase 4 and the next
// phase 1 need none between them, since one thread owns a node in both.
//
// Same bits as the launch sequence B, J.v, C (in 3D the J.v is kernel U):
// phase 1 sums each output over its group's j in increasing order from 0
// (B's order, with nvcc's FMA contraction of the same expression); phase 2
// is the J.v's own body and order; phase
// 3 is C's partition (nb = lmr_partial_blocks(n) slots of 256 entries per
// group, C's strided assignment and shared-memory tree), one CTA of 256
// threads reducing one slot as C's stage-1 block does, the slots spread over
// the CTAs; phase 4 sums a group's slots in index order and forms alpha in
// f64, then updates as lmr_update_kernel does. So alpha equals C's wherever z
// and A z do, and a rerun gives the same bits: no atomics.
//
// Barrier: the grid is launched cooperatively (cudaLaunchCooperativeKernel)
// at min(blocks needed, co-resident blocks) and syncs with
// cooperative_groups::this_grid().sync(); every loop is grid-stride, so a
// smaller grid only loops more. A grid of one CTA is launched plainly and
// syncs with __syncthreads; asked for by the wrapper, one CTA measured
// 1.8-40x slower than the grid at every level of the main paths, 25^2
// included (H100, chip_smoke.py phase 22), so the wrapper runs the grid. A
// launch that cannot be made returns its CUDA error; nothing falls back to
// the launch sequence.
//
// Memory: z and A z are device scratch from the wrapper; planes written
// during the launch (z, A z, r, the partials) are read at L2 (__ldcg, the
// LoadCG policy of the gather) wherever another thread wrote them, never
// through the read-only cache. The state, P^-1 and the mask are read-only.
//
// What bounds it on the H100: the sweeps' operations (n times the J.v's) at
// the large levels, the bytes of state, P^-1 and (x, r) once at the small
// ones; every level's working set is L2-resident (bench3's 350^2: 245,701
// nodes x ~14 floats, ~14 MB). The design removes the 3n host wrapper calls
// and 4n launches of the sequence; what it adds is 3n grid barriers.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "fem_jvp.cuh"
#include "fem_tet_tile.cuh"

namespace pfh {

constexpr int kLoopThreads = 256;  // lmr.cu's kRedThreads: one slot per CTA
constexpr int kLoopMaxSlots = 64;  // lmr.cu's nb bound

// The operands of one launch. Planes are unpadded, field-major: 2D v planes
// [F, ny+1, nx+1] and m planes [F, ny, nx]; 3D v planes [F, nz+1, ny+1, nx+1]
// with ncell = 0 and null m pointers. Nodes are indexed vertices first.
struct LoopArgs {
  float* xv;
  float* xm;
  float* rv;
  float* rm;
  float* zv;  // scratch: z
  float* zm;
  float* av;  // scratch: A z
  float* am;
  const float* pv;    // P^-1 planes [F, F, .]
  const float* pm;
  const float* wv;    // linearization state
  const float* wm;
  const float* mask;  // [F, vertices] Dirichlet rows, or null
  double* partials;   // 2 * G.n * nb
  long nvert, ncell;
  int nz, ny, nx;
  int n_sweeps, nb;
  FieldGroups G;
};

// A node's plane offset: its leaf's base pointer is picked by on_v.
struct Node {
  bool on_v;
  long i;  // index within its leaf's plane
  long n;  // nodes of one field of that leaf
  __device__ __forceinline__ Node(const LoopArgs& A, long idx)
      : on_v(idx < A.nvert), i(on_v ? idx : idx - A.nvert),
        n(on_v ? A.nvert : A.ncell) {}
  __device__ __forceinline__ long at(int f) const { return f * n + i; }
};

__device__ __forceinline__ void loop_barrier() {
  if (gridDim.x == 1)
    __syncthreads();
  else
    cooperative_groups::this_grid().sync();
}

// The CTAs a phase's loops stride over and its barrier: here the whole grid
// (kernel L, the chains). Kernel V (vcycle_fused.cuh) runs a level's phases
// on cluster 0 alone through another scope with the same three members; a
// loop strides over rank() of size() CTAs, so the bits do not depend on it.
struct GridScope {
  __device__ __forceinline__ int rank() const { return blockIdx.x; }
  __device__ __forceinline__ int size() const { return gridDim.x; }
  __device__ __forceinline__ void sync() const { loop_barrier(); }
};

// The level's phase 2, A z of the whole level into av/am, grid-stride, and
// the CTAs and dynamic shared bytes it asks for. 2D: per node, the gather
// J.v of Phys at NQ points; a Dirichlet row (mask != 0) gives z.
template <class Phys, int NQ>
struct Level2 {
  using Params = JvpParams;
  static constexpr int NF = Phys::NF;
  static constexpr int kSmemBytes = 0;
  static Params load(const float* params) { return load_params(params); }
  static long blocks(const LoopArgs& A) {
    return blocks_for(A.nvert + A.ncell, kLoopThreads);
  }
  template <class Sc>
  __device__ __forceinline__ static void az(const Params& P, const LoopArgs& A,
                                            float*, const Sc& sc) {
    const long N = A.nvert + A.ncell;
    for (long idx = static_cast<long>(sc.rank()) * blockDim.x + threadIdx.x;
         idx < N; idx += static_cast<long>(sc.size()) * blockDim.x) {
      const Node nd(A, idx);
      float acc[NF];
      jvp_node<Phys, NQ, LoadCG>(P, A.wv, A.wm, A.zv, A.zm, idx, A.ny, A.nx,
                                 acc);
      const float* z = nd.on_v ? A.zv : A.zm;
      float* az = nd.on_v ? A.av : A.am;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        float val = acc[f];
        if (nd.on_v && A.mask != nullptr && __ldg(A.mask + nd.at(f)) != 0.f)
          val = __ldcg(z + nd.at(f));
        az[nd.at(f)] = val;
      }
    }
  }
};

// ... and 3D (Kuhn tets): kernel U's body (fem_tet_tile.cuh) per box, in
// U's order, so that L gives the bits of the launch sequence B, U, C. The
// CTA is U's (kLoopThreads == kTetThreads). With kMask a Dirichlet row
// (mask != 0) gives z, as U's store and the 2D gather's do.
template <class Phys, int NQ, bool kMask = false>
struct Level3 {
  using Params = Jvp3Params;
  static constexpr int NF = Phys::NF;
  static constexpr int kSmemBytes =
      static_cast<int>(sizeof(float)) * tet_box_floats<Phys>();
  static Params load(const float* params) { return load_params3(params); }
  static long blocks(const LoopArgs& A) {
    return std::max(static_cast<long>(blocks_for(A.nvert, kLoopThreads)),
                    tet_boxes(A.nz, A.ny, A.nx));
  }
  template <class Sc>
  __device__ __forceinline__ static void az(const Params& P, const LoopArgs& A,
                                            float* smem, const Sc& sc) {
    const long nbox = tet_boxes(A.nz, A.ny, A.nx);
    for (long b = sc.rank(); b < nbox; b += sc.size())
      tet_box<Phys, NQ, kMask, LoadCG>(P, A.wv, A.zv, nullptr, A.mask, A.av,
                                       A.nz, A.ny, A.nx, b, smem);
  }
};
static_assert(kLoopThreads == kTetThreads, "L's 3D A z runs U's CTA");

// Phase 1: z = P^-1 r at the node from its r values rr; in-group j only, in
// increasing order (B's sum; j unrolled, so rr stays in registers).
template <int NF>
__device__ __forceinline__ void bj_node(const LoopArgs& A, const Node& nd,
                                        const float (&rr)[NF]) {
  const float* P = nd.on_v ? A.pv : A.pm;
  float* z = nd.on_v ? A.zv : A.zm;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int g = group_of(A.G, i);
    const int lo = A.G.start[g], hi = A.G.start[g + 1];
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NF; ++j)
      if (j >= lo && j < hi)
        acc += __ldg(P + (static_cast<long>(i) * NF + j) * nd.n + nd.i) * rr[j];
    z[nd.at(i)] = acc;
  }
}

// Phase 3: the f64 partials of <Az, r>_g and <Az, Az>_g, C's stage 1 slot by
// slot: slot (g, b) is block (b, g) of lmr_partials_kernel.
template <class Sc>
__device__ __forceinline__ void partial_slots(const LoopArgs& A,
                                              double* s_num, double* s_den,
                                              const Sc& sc) {
  const int t = threadIdx.x;
  const int nslots = A.G.n * A.nb;
  for (int slot = sc.rank(); slot < nslots; slot += sc.size()) {
    const int g = slot / A.nb, b = slot % A.nb;
    const long f0 = A.G.start[g];
    const long nf = A.G.start[g + 1] - f0;
    const long nv = nf * A.nvert;  // the group's v entries come first
    const long n = nv + nf * A.ncell;
    const float* av = A.av + f0 * A.nvert;
    const float* am = A.am + f0 * A.ncell;
    const float* qv = A.rv + f0 * A.nvert;
    const float* qm = A.rm + f0 * A.ncell;
    double num = 0.0, den = 0.0;
    for (long i = static_cast<long>(b) * kLoopThreads + t; i < n;
         i += static_cast<long>(A.nb) * kLoopThreads) {
      const double a = i < nv ? __ldcg(av + i) : __ldcg(am + (i - nv));
      num += a * (i < nv ? __ldcg(qv + i) : __ldcg(qm + (i - nv)));
      den += a * a;
    }
    s_num[t] = num;
    s_den[t] = den;
    __syncthreads();
    for (int stride = kLoopThreads / 2; stride > 0; stride >>= 1) {
      if (t < stride) {
        s_num[t] += s_num[t + stride];
        s_den[t] += s_den[t + stride];
      }
      __syncthreads();
    }
    if (t == 0) {
      A.partials[g * A.nb + b] = s_num[0];
      A.partials[(A.G.n + g) * A.nb + b] = s_den[0];
    }
    __syncthreads();
  }
}

// The shared memory of the sweep loop: phase 3's tree, phase 4's staged
// partials and the step lengths.
struct LoopShared {
  double num[kLoopThreads];
  double den[kLoopThreads];
  double part[2 * kMaxGroups * kLoopMaxSlots];
  float alpha[kMaxGroups];
};

// The n sweeps of one level (A.n_sweeps) on (x, r) in place: L's body, and
// the sweeps of each level of the V-cycle chains (vcycle_chain.cuh) and of
// kernel V (vcycle_fused.cuh), which run it between their own barriers.
// Every loop strides over the scope's CTAs (the grid, or V's cluster 0) and
// the slots are C's partition, so the bits do not depend on the scope. A
// thread reads r at its own nodes with plain loads: a caller that wrote r
// before must have written those nodes from the same thread (the node loop
// below, in the same scope), or put a barrier between.
template <class Lv, class Sc = GridScope>
__device__ __forceinline__ void lmr_sweeps(const typename Lv::Params& P,
                                           const LoopArgs& A, LoopShared& sh,
                                           float* smem, const Sc& sc = Sc{}) {
  constexpr int NF = Lv::NF;
  const long N = A.nvert + A.ncell;
  const long first = static_cast<long>(sc.rank()) * blockDim.x + threadIdx.x;
  const long stride = static_cast<long>(sc.size()) * blockDim.x;

  for (long idx = first; idx < N; idx += stride) {  // phase 1 of sweep 0
    const Node nd(A, idx);
    const float* r = nd.on_v ? A.rv : A.rm;
    float rr[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) rr[f] = r[nd.at(f)];
    bj_node<NF>(A, nd, rr);
  }
  for (int s = 0; s < A.n_sweeps; ++s) {
    sc.sync();
    Lv::az(P, A, smem, sc);  // phase 2
    sc.sync();
    partial_slots(A, sh.num, sh.den, sc);  // phase 3
    sc.sync();
    // phase 4: alpha per group, as C's stage 2: the partials staged in
    // shared memory by the whole CTA at once, then summed in index order
    for (int i = threadIdx.x; i < 2 * A.G.n * A.nb; i += blockDim.x)
      sh.part[i] = __ldcg(A.partials + i);
    __syncthreads();
    if (threadIdx.x < A.G.n) {
      const int g = threadIdx.x;
      double num = 0.0, den = 0.0;
#pragma unroll 8
      for (int b = 0; b < A.nb; ++b) {
        num += sh.part[g * A.nb + b];
        den += sh.part[(A.G.n + g) * A.nb + b];
      }
      sh.alpha[g] = den > 0.0 ? static_cast<float>(num / den) : 0.0f;
    }
    __syncthreads();
    const bool next = s + 1 < A.n_sweeps;
    for (long idx = first; idx < N; idx += stride) {
      const Node nd(A, idx);
      float* x = nd.on_v ? A.xv : A.xm;
      float* r = nd.on_v ? A.rv : A.rm;
      const float* z = nd.on_v ? A.zv : A.zm;
      const float* az = nd.on_v ? A.av : A.am;
      float rr[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const long o = nd.at(f);
        const float alpha = sh.alpha[group_of(A.G, f)];
        x[o] += alpha * z[o];
        r[o] -= alpha * az[o];
        rr[f] = r[o];
      }
      if (next) bj_node<NF>(A, nd, rr);
    }
    __syncthreads();  // alpha is rewritten by the next sweep's phase 4
  }
}

template <class Lv>
__global__ void __launch_bounds__(kLoopThreads)
lmr_loop_kernel(const typename Lv::Params P, const LoopArgs A) {
  __shared__ LoopShared sh;
  extern __shared__ float lmr_smem[];  // Lv::kSmemBytes: phase 2's
  lmr_sweeps<Lv>(P, A, sh, lmr_smem);
}

// Lets an instantiation take its level's dynamic shared bytes (above 48 KB
// a kernel must ask for them), once.
template <class Lv>
inline cudaError_t allow_loop_smem() {
  static const cudaError_t err =
      Lv::kSmemBytes == 0
          ? cudaSuccess
          : cudaFuncSetAttribute(
                reinterpret_cast<const void*>(lmr_loop_kernel<Lv>),
                cudaFuncAttributeMaxDynamicSharedMemorySize, Lv::kSmemBytes);
  return err;
}

// Co-resident CTAs of one instantiation on the current device (cached), with
// its dynamic shared bytes.
template <class Lv>
inline int resident_ctas() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (allow_loop_smem<Lv>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, lmr_loop_kernel<Lv>, kLoopThreads, Lv::kSmemBytes) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

// one_cta: nonzero runs one CTA, else the cooperative grid of min(blocks
// needed, co-resident CTAs). *grid_out: the CTAs run.
template <class Lv>
int launch_lmr_loop(const float* params, const LoopArgs& A, int one_cta,
                    int* grid_out, void* stream) {
  if (A.nb < 1 || A.nb > kLoopMaxSlots || A.n_sweeps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const typename Lv::Params P = Lv::load(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t smem_err = allow_loop_smem<Lv>();
  if (smem_err != cudaSuccess) return static_cast<int>(smem_err);
  int grid = 1;
  if (!one_cta) {
    const long need =
        std::max(Lv::blocks(A), static_cast<long>(A.G.n) * A.nb);
    const int resident = resident_ctas<Lv>();
    if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid = static_cast<int>(std::min(need, static_cast<long>(resident)));
  }
  *grid_out = grid;
  if (grid == 1) {
    lmr_loop_kernel<Lv><<<1, kLoopThreads, Lv::kSmemBytes, s>>>(P, A);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {const_cast<typename Lv::Params*>(&P),
                  const_cast<LoopArgs*>(&A)};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)lmr_loop_kernel<Lv>, dim3(grid), dim3(kLoopThreads), args,
      Lv::kSmemBytes, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The point-count dispatch of a 2D level (rules of 1, 3 or 4 points).
template <class Phys>
int launch_lmr_loop2(const float* params, int nq, const LoopArgs& A,
                     int one_cta, int* grid_out, void* stream) {
  switch (nq) {
    case 1:
      return launch_lmr_loop<Level2<Phys, 1>>(params, A, one_cta, grid_out, stream);
    case 3:
      return launch_lmr_loop<Level2<Phys, 3>>(params, A, one_cta, grid_out, stream);
    case 4:
      return launch_lmr_loop<Level2<Phys, 4>>(params, A, one_cta, grid_out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ... and of a 3D one (keast1, keast2, ffc3: 1, 4 or 8 points).
template <class Phys, bool kMask>
int launch_lmr_loop3(const float* params, int nq, const LoopArgs& A,
                     int one_cta, int* grid_out, void* stream) {
  switch (nq) {
    case 1:
      return launch_lmr_loop<Level3<Phys, 1, kMask>>(params, A, one_cta,
                                                     grid_out, stream);
    case 4:
      return launch_lmr_loop<Level3<Phys, 4, kMask>>(params, A, one_cta,
                                                     grid_out, stream);
    case 8:
      return launch_lmr_loop<Level3<Phys, 8, kMask>>(params, A, one_cta,
                                                     grid_out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch of a 2D level of physics Phys, and of a 3D one (null m
// pointers, ncell = 0): the operands as LoopArgs names them; nb: the slots
// per group; starts: n_groups + 1 host ints (make_groups) or null. A 3D
// level's Dirichlet mask comes after its cells (null: none; an
// instantiation without kMask refuses one).
template <class Phys>
int lmr_loop2(const float* params, int nq, float* xv, float* xm, float* rv,
              float* rm, float* zv, float* zm, float* av, float* am,
              const float* pv, const float* pm, const float* wv, const float* wm,
              const float* mask, double* partials, int nb, int n_groups,
              const int* starts, int n_sweeps, int ny, int nx, int one_cta,
              int* grid_out, void* stream) {
  LoopArgs A{xv, xm, rv, rm, zv, zm, av, am, pv, pm, wv, wm, mask, partials,
             static_cast<long>(ny + 1) * (nx + 1), static_cast<long>(ny) * nx,
             0, ny, nx, n_sweeps, nb, FieldGroups{}};
  if (!make_groups(Phys::NF, n_groups, starts, &A.G))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_lmr_loop2<Phys>(params, nq, A, one_cta, grid_out, stream);
}

template <class Phys, bool kMask = false>
int lmr_loop3(const float* params, int nq, float* xv, float* rv, float* zv,
              float* av, const float* pv, const float* wv, double* partials,
              int nb, int n_groups, const int* starts, int n_sweeps, int nz,
              int ny, int nx, const float* mask, int one_cta, int* grid_out,
              void* stream) {
  if (!kMask && mask != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  LoopArgs A{xv, nullptr, rv, nullptr, zv, nullptr, av, nullptr, pv, nullptr,
             wv, nullptr, mask, partials,
             static_cast<long>(nz + 1) * (ny + 1) * (nx + 1), 0, nz, ny, nx,
             n_sweeps, nb, FieldGroups{}};
  if (!make_groups(Phys::NF, n_groups, starts, &A.G))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_lmr_loop3<Phys, kMask>(params, nq, A, one_cta, grid_out, stream);
}

// Registers, spill bytes, static and dynamic shared bytes and co-resident
// CTAs per SM of L's 3D form at nq points (common.cuh kernel_info).
template <class Phys, bool kMask, int NQ>
int lmr_loop3_info_nq(int* out) {
  using Lv = Level3<Phys, NQ, kMask>;
  const cudaError_t err = allow_loop_smem<Lv>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return kernel_info(lmr_loop_kernel<Lv>, kLoopThreads, Lv::kSmemBytes, out);
}

template <class Phys, bool kMask = false>
int lmr_loop3_info(int nq, int* out) {
  switch (nq) {
    case 4: return lmr_loop3_info_nq<Phys, kMask, 4>(out);
    case 8: return lmr_loop3_info_nq<Phys, kMask, 8>(out);
    case 1: return lmr_loop3_info_nq<Phys, kMask, 1>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace pfh
