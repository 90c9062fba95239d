// Kernel H, transfer_general: prolongation and restriction (its exact
// transpose) between crossed-P1 levels with an equal odd ratio R in
// {3, 5, 7} (fine nx = R nxc, ny = R nyc; bench3's 175 -> 35 -> 7), f32.
//
// Replaces the SVD-separated transfer matmuls of
// pfhubbenchmarks_tpu/ops/pallas_vcycle.py (_GenLevelMats, built by
// ops/transfer_mats.py:build_general_mats) inside make_fused_descend and
// make_fused_ascend. Those matmuls existed only because Mosaic rejects
// strided access; the stencils here follow solve/transfer.py:
// prolong_general (:141) and restrict_general (:203, its transpose).
//
// The per-node bodies are transfer.cuh's (general_prolong_node,
// general_restrict_vertex, general_restrict_centre): every product and sum
// one rounded __fmul_rn / __fadd_rn in the order of the plain versions in
// ops/transfer.py, so the two agree to the bit. The class tables (GenWeights,
// host-built from _p1_weights) live in device memory, one slot per R,
// uploaded once per device by pfh_transfer_general_upload: no launch carries
// them.
//
// Dirichlet rows: the optional 0/1 vertex mask of the OUTPUT grid, as in
// kernel D (transfer.cu).
//
// Design. Prolongation: one thread per (field, fine node); its class's
// weights are read from the slot (L1-cached). Restriction: a coarse vertex
// chains ~4 x 2 R^2 rounded multiply-adds, in a fixed order, over fine
// nodes R floats apart. A CTA takes one field, one coarse row I and a chunk
// of at most kChunk coarse columns; its four warps first stage, with
// coalesced loads, the fine vertex and centre rows R (I - 1) .. R (I + 1) - 1
// of the columns the chunk reads into shared memory (2R rows of
// R (kChunk + 1) floats per plane: 26 KB at R = 7), then warp 0 runs the
// chunk's coarse vertices and warp 1 its coarse centres out of shared
// memory (lanes R floats apart: no bank conflicts for odd R), reading the
// weights from a copy of the slot staged with the strip (every index a
// compile-time constant). The chunk is balanced over the row: 175 -> 35 runs 2 chunks of
// 18 columns x 36 rows x 2 fields = 144 CTAs, where one thread per coarse
// node and a field loop ran 20.
//
// What bounds it on the H100: bench3's 175^2 <-> 35^2 pair moves ~0.7 MB
// (F = 2), L2-resident; the restriction's chains are ~270 dependent adds
// that keep their order: the launch, one round trip to L2 for the strip,
// then one chain per thread (on an H100 SXM at 700 W, tools/
// torch_transfer_probe.py: 4.55 us at 175 -> 35 and 4.33 at 35 -> 7, where a
// load and a store per staged float took 6.57 / 5.84 and the weights as
// constant-bank operands 5.38 / 5.36).

#include <cuda_pipeline.h>

#include "transfer.cuh"

namespace {

using namespace pfh::xfer;

constexpr int kChunk = 32;           // coarse vertex columns per CTA, at most
constexpr int kStripThreads = 128;   // staging threads; warps 0 and 1 compute

__device__ GenWeights g_weights[3];   // R = 3, 5, 7: slot (R - 3) / 2

// One float of the strip, device memory -> shared memory, as an
// asynchronous copy (cp.async): the copy holds no register, so a thread
// issues all of its strip's copies without waiting for any, and the strip
// costs one round trip to L2, not one per row.
__device__ __forceinline__ void stage(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

// The class tables of slot `slot`, staged in shared memory beside the strip:
// the chains then read each weight as a shared load (one address for the
// warp: a broadcast) that runs ahead of the adds, where a constant-bank
// operand would stall its multiply on every constant-cache miss.
__device__ __forceinline__ void stage_weights(GenWeights* sw, int slot) {
  const float* src = reinterpret_cast<const float*>(&g_weights[slot]);
  float* dst = reinterpret_cast<float*>(sw);
  for (int k = threadIdx.x; k < kGenParamFloats; k += blockDim.x)
    stage(dst + k, src + k);
}

template <int R>
__global__ void __launch_bounds__(pfh::kThreads)
prolong_general_kernel(const float* __restrict__ vc, const float* __restrict__ mc,
                       float* __restrict__ vf, float* __restrict__ mf,
                       const float* __restrict__ mask, int nyc, int nxc,
                       int accumulate) {
  const int nyf = R * nyc, nxf = R * nxc, nvxf = nxf + 1;
  const long nvf = static_cast<long>(nyf + 1) * nvxf;
  const long nmf = static_cast<long>(nyf) * nxf;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvf + nmf) return;
  const int f = blockIdx.y;
  const bool vert = idx < nvf;
  const long c = vert ? idx : idx - nvf;
  const int Y = static_cast<int>(vert ? c / nvxf : c / nxf);
  const int X = static_cast<int>(vert ? c % nvxf : c % nxf);
  const float* v = vc + f * static_cast<long>(nyc + 1) * (nxc + 1);
  const float* m = mc + f * static_cast<long>(nyc) * nxc;
  float val = general_prolong_node<R>(g_weights[(R - 3) / 2], v, m, vert, Y, X,
                                      nyc, nxc);
  float* out;
  if (vert) {
    if (mask != nullptr && __ldg(mask + f * nvf + c) != 0.f) val = 0.f;
    out = vf + f * nvf + c;
  } else {
    out = mf + f * nmf + c;
  }
  *out = accumulate ? add(*out, val) : val;
}

// grid (column chunks, nyc + 1 coarse rows, F); `chunk` coarse columns each
template <int R>
__global__ void __launch_bounds__(kStripThreads)
restrict_general_kernel(const float* __restrict__ vf, const float* __restrict__ mf,
                        float* __restrict__ vc, float* __restrict__ mc,
                        const float* __restrict__ mask, int nyc, int nxc,
                        int chunk) {
  constexpr int kW = R * (kChunk + 1);   // staged fine columns
  constexpr int kH = 2 * R;              // staged fine rows
  __shared__ float sv[kH * kW];
  __shared__ float sm[kH * kW];
  __shared__ GenWeights sw;
  const int I = blockIdx.y, f = blockIdx.z;
  const int J0 = blockIdx.x * chunk;
  const int nc = min(chunk, nxc + 1 - J0);   // this CTA's coarse columns
  const int nyf = R * nyc, nxf = R * nxc, nvxf = nxf + 1;
  const float* v = vf + f * static_cast<long>(nyf + 1) * nvxf;
  const float* m = mf + f * static_cast<long>(nyf) * nxf;
  // the strip: fine rows y0 .. y0 + 2R - 1, columns x0 .. x0 + R (nc + 1) - 1,
  // clipped to each plane
  const int y0 = R * (I - 1), x0 = R * (J0 - 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int ylo = max(y0, 0), xlo = max(x0, 0);
  const int yend = y0 + kH, xend = x0 + R * (nc + 1);
  for (int y = ylo + warp; y < min(yend, nyf + 1); y += nwarps)
    for (int x = xlo + lane; x < min(xend, nvxf); x += 32)
      stage(&sv[(y - y0) * kW + (x - x0)], v + y * nvxf + x);
  for (int y = ylo + warp; y < min(yend, nyf); y += nwarps)
    for (int x = xlo + lane; x < min(xend, nxf); x += 32)
      stage(&sm[(y - y0) * kW + (x - x0)], m + y * nxf + x);
  stage_weights(&sw, (R - 3) / 2);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const GenWeights& W = sw;
  const TilePlane<kW> tv{sv, y0, x0}, tm{sm, y0, x0};
  if (warp == 0 && lane < nc) {
    const int J = J0 + lane;
    const long nvc = static_cast<long>(nyc + 1) * (nxc + 1);
    const long o = f * nvc + static_cast<long>(I) * (nxc + 1) + J;
    float acc = general_restrict_vertex<R>(W, tv, tm, I, J, nyc, nxc);
    if (mask != nullptr && __ldg(mask + o) != 0.f) acc = 0.f;
    vc[o] = acc;
  } else if (warp == 1 && lane < nc && I < nyc && J0 + lane < nxc) {
    const int j = J0 + lane;
    mc[f * static_cast<long>(nyc) * nxc + static_cast<long>(I) * nxc + j] =
        general_restrict_centre<R>(W, tv, tm, I, j);
  }
}

template <int R>
int launch(int op, const float* src_v, const float* src_m, float* dst_v,
           float* dst_m, const float* mask, int F, int nyc, int nxc,
           int accumulate, cudaStream_t s) {
  if (op == 0) {
    const long nvf = static_cast<long>(R * nyc + 1) * (R * nxc + 1);
    const long nmf = static_cast<long>(R * nyc) * (R * nxc);
    prolong_general_kernel<R><<<dim3(pfh::blocks_for(nvf + nmf), F), pfh::kThreads,
                                0, s>>>(src_v, src_m, dst_v, dst_m, mask, nyc,
                                        nxc, accumulate);
  } else if (op == 1) {
    if (nyc + 1 > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const int n_chunks = (nxc + 1 + kChunk - 1) / kChunk;
    const int chunk = (nxc + 1 + n_chunks - 1) / n_chunks;
    restrict_general_kernel<R><<<dim3(n_chunks, nyc + 1, F), kStripThreads, 0,
                                 s>>>(src_v, src_m, dst_v, dst_m, mask, nyc,
                                      nxc, chunk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The class tables of ratio R (kGenParamFloats floats in the order of
// GenWeights) into R's slot on the current device; once per device
// and R, before the first launch with R. Synchronizes the device, so no
// later launch on any stream can run before the copy lands.
PFH_EXPORT int pfh_transfer_general_upload(int R, const float* params) {
  if (R != 3 && R != 5 && R != 7) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaMemcpyToSymbol(
      g_weights, params, sizeof(GenWeights), (R - 3) / 2 * sizeof(GenWeights),
      cudaMemcpyHostToDevice);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceSynchronize());
}

// op 0: prolong (src coarse -> dst fine; accumulate adds into dst)
// op 1: restrict (src fine -> dst coarse)
// mask: null, or the 0/1 Dirichlet vertex mask of dst
PFH_EXPORT int pfh_transfer_general(int op, int R, const float* src_v,
                                    const float* src_m, float* dst_v,
                                    float* dst_m, const float* mask, int F,
                                    int nyc, int nxc, int accumulate,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F < 1 || F > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (R) {
    case 3:
      return launch<3>(op, src_v, src_m, dst_v, dst_m, mask, F, nyc, nxc, accumulate, s);
    case 5:
      return launch<5>(op, src_v, src_m, dst_v, dst_m, mask, F, nyc, nxc, accumulate, s);
    case 7:
      return launch<7>(op, src_v, src_m, dst_v, dst_m, mask, F, nyc, nxc, accumulate, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

PFH_EXPORT int pfh_transfer_general_param_floats() { return kGenParamFloats; }
