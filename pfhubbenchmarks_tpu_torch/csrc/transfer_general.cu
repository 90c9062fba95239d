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
// Prolongation: a fine vertex or centre of coarse cell (i, j) at class
// (py, px) is sum_k w[py][px][k] * slot_k over the cell's five slots (SW,
// SE, NW, NE corners, centre), with the host-built class tables of
// _p1_weights (GenWeights, passed by value); the last fine vertex row and
// column interpolate along the coarse edge with weights 1 - px/R and px/R,
// and the last corner is copied. Restriction gathers, per coarse vertex,
// the fine nodes of its (up to) four cells that read it (each cell's
// vertex classes, then its centre classes) and then the last row's and
// column's 1-D terms; per coarse centre, the nodes of its own cell. Every
// product and sum is one rounded __fmul_rn / __fadd_rn (no FMA
// contraction), in the order of the plain versions in ops/transfer.py, so
// the two agree to the bit.
//
// Dirichlet rows: the optional 0/1 vertex mask of the OUTPUT grid, as in
// kernel D (transfer.cu).
//
// Design: one thread per output node, a loop over fields, no atomics. R is
// a template parameter, so the class loops unroll and every table index is
// a compile-time constant except the prolongation's (py, px).
//
// What bounds it on the H100: bench3's 175^2 <-> 35^2 pair moves ~0.7 MB
// (F = 2), L2-resident: launch latency, one partial wave.

#include "common.cuh"

namespace {

constexpr int kMaxR = 7;

struct GenWeights {
  float wv[kMaxR][kMaxR][5];  // fine vertex classes (py, px) over the slots
  float wm[kMaxR][kMaxR][5];  // fine centre classes
  float frac[kMaxR];          // px / R on the last row and column
  float one_minus[kMaxR];     // 1 - px / R
};

constexpr int kGenParamFloats = sizeof(GenWeights) / sizeof(float);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

template <int R>
__global__ void __launch_bounds__(pfh::kThreads)
prolong_general_kernel(const GenWeights W, const float* __restrict__ vc,
                       const float* __restrict__ mc, float* __restrict__ vf,
                       float* __restrict__ mf, const float* __restrict__ mask,
                       int F, int nyc, int nxc, int accumulate) {
  const int nvxc = nxc + 1;
  const long nvc = static_cast<long>(nyc + 1) * nvxc;
  const long nmc = static_cast<long>(nyc) * nxc;
  const int nyf = R * nyc, nxf = R * nxc, nvxf = nxf + 1;
  const long nvf = static_cast<long>(nyf + 1) * nvxf;
  const long nmf = static_cast<long>(nyf) * nxf;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvf + nmf) return;
  const bool vert = idx < nvf;
  const long c = vert ? idx : idx - nvf;
  const int Y = static_cast<int>(vert ? c / nvxf : c / nxf);
  const int X = static_cast<int>(vert ? c % nvxf : c % nxf);
  const int i = Y / R, py = Y - R * i;
  const int j = X / R, px = X - R * j;
  for (int f = 0; f < F; ++f) {
    const float* v = vc + f * nvc;
    const float* m = mc + f * nmc;
    float val;
    if (Y < nyf && X < nxf) {
      const float* w = vert ? W.wv[py][px] : W.wm[py][px];
      val = mul(w[0], __ldg(v + i * nvxc + j));
      val = add(val, mul(w[1], __ldg(v + i * nvxc + j + 1)));
      val = add(val, mul(w[2], __ldg(v + (i + 1) * nvxc + j)));
      val = add(val, mul(w[3], __ldg(v + (i + 1) * nvxc + j + 1)));
      val = add(val, mul(w[4], __ldg(m + i * nxc + j)));
    } else if (Y == nyf && X < nxf) {   // last fine row: along the top edge
      val = add(mul(W.one_minus[px], __ldg(v + nyc * nvxc + j)),
                mul(W.frac[px], __ldg(v + nyc * nvxc + j + 1)));
    } else if (X == nxf && Y < nyf) {   // last fine column: the right edge
      val = add(mul(W.one_minus[py], __ldg(v + i * nvxc + nxc)),
                mul(W.frac[py], __ldg(v + (i + 1) * nvxc + nxc)));
    } else {                            // the last corner
      val = __ldg(v + nyc * nvxc + nxc);
    }
    float* out;
    if (vert) {
      if (mask != nullptr && __ldg(mask + f * nvf + idx) != 0.f) val = 0.f;
      out = vf + f * nvf + c;
    } else {
      out = mf + f * nmf + c;
    }
    *out = accumulate ? add(*out, val) : val;
  }
}

// acc += the fine nodes of coarse cell (ci, cj) that read its slot S
// (vertex classes, then centre classes, (py, px) row-major).
template <int R, int S>
__device__ __forceinline__ float gather_cell(const GenWeights& W,
                                             const float* __restrict__ v,
                                             const float* __restrict__ m,
                                             int ci, int cj, int nvxf, int nxf,
                                             float acc) {
#pragma unroll
  for (int py = 0; py < R; ++py)
#pragma unroll
    for (int px = 0; px < R; ++px)
      acc = add(acc, mul(W.wv[py][px][S],
                         __ldg(v + (R * ci + py) * nvxf + R * cj + px)));
#pragma unroll
  for (int py = 0; py < R; ++py)
#pragma unroll
    for (int px = 0; px < R; ++px)
      acc = add(acc, mul(W.wm[py][px][S],
                         __ldg(m + (R * ci + py) * nxf + R * cj + px)));
  return acc;
}

template <int R>
__global__ void __launch_bounds__(pfh::kThreads)
restrict_general_kernel(const GenWeights W, const float* __restrict__ vf,
                        const float* __restrict__ mf, float* __restrict__ vc,
                        float* __restrict__ mc, const float* __restrict__ mask,
                        int F, int nyc, int nxc) {
  const int nvxc = nxc + 1;
  const long nvc = static_cast<long>(nyc + 1) * nvxc;
  const long nmc = static_cast<long>(nyc) * nxc;
  const int nyf = R * nyc, nxf = R * nxc, nvxf = nxf + 1;
  const long nvf = static_cast<long>(nyf + 1) * nvxf;
  const long nmf = static_cast<long>(nyf) * nxf;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nvc + nmc) return;
  for (int f = 0; f < F; ++f) {
    const float* v = vf + f * nvf;
    const float* m = mf + f * nmf;
    if (idx < nvc) {
      const int I = static_cast<int>(idx / nvxc), J = static_cast<int>(idx % nvxc);
      float acc = 0.f;
      // coarse vertex (I, J) is slot SW of cell (I, J), SE of (I, J-1),
      // NW of (I-1, J) and NE of (I-1, J-1)
      if (I < nyc && J < nxc) acc = gather_cell<R, 0>(W, v, m, I, J, nvxf, nxf, acc);
      if (I < nyc && J > 0) acc = gather_cell<R, 1>(W, v, m, I, J - 1, nvxf, nxf, acc);
      if (I > 0 && J < nxc) acc = gather_cell<R, 2>(W, v, m, I - 1, J, nvxf, nxf, acc);
      if (I > 0 && J > 0) acc = gather_cell<R, 3>(W, v, m, I - 1, J - 1, nvxf, nxf, acc);
      if (I == nyc) {   // the last fine row reads the top edge
        if (J < nxc)
#pragma unroll
          for (int p = 0; p < R; ++p)
            acc = add(acc, mul(W.one_minus[p], __ldg(v + nyf * nvxf + R * J + p)));
        if (J > 0)
#pragma unroll
          for (int p = 0; p < R; ++p)
            acc = add(acc, mul(W.frac[p], __ldg(v + nyf * nvxf + R * (J - 1) + p)));
      }
      if (J == nxc) {   // the last fine column reads the right edge
        if (I < nyc)
#pragma unroll
          for (int p = 0; p < R; ++p)
            acc = add(acc, mul(W.one_minus[p], __ldg(v + (R * I + p) * nvxf + nxf)));
        if (I > 0)
#pragma unroll
          for (int p = 0; p < R; ++p)
            acc = add(acc, mul(W.frac[p], __ldg(v + (R * (I - 1) + p) * nvxf + nxf)));
      }
      if (I == nyc && J == nxc) acc = add(acc, __ldg(v + nyf * nvxf + nxf));
      if (mask != nullptr && __ldg(mask + f * nvc + idx) != 0.f) acc = 0.f;
      vc[f * nvc + idx] = acc;
    } else {
      const long c = idx - nvc;
      const int i = static_cast<int>(c / nxc), j = static_cast<int>(c % nxc);
      mc[f * nmc + c] = gather_cell<R, 4>(W, v, m, i, j, nvxf, nxf, 0.f);
    }
  }
}

template <int R>
int launch(int op, const GenWeights& W, const float* src_v, const float* src_m,
           float* dst_v, float* dst_m, const float* mask, int F, int nyc,
           int nxc, int accumulate, cudaStream_t s) {
  const long nvc = static_cast<long>(nyc + 1) * (nxc + 1);
  const long nmc = static_cast<long>(nyc) * nxc;
  const long nvf = static_cast<long>(R * nyc + 1) * (R * nxc + 1);
  const long nmf = static_cast<long>(R * nyc) * (R * nxc);
  if (op == 0) {
    prolong_general_kernel<R><<<pfh::blocks_for(nvf + nmf), pfh::kThreads, 0, s>>>(
        W, src_v, src_m, dst_v, dst_m, mask, F, nyc, nxc, accumulate);
  } else if (op == 1) {
    restrict_general_kernel<R><<<pfh::blocks_for(nvc + nmc), pfh::kThreads, 0, s>>>(
        W, src_v, src_m, dst_v, dst_m, mask, F, nyc, nxc);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op 0: prolong (src coarse -> dst fine; accumulate adds into dst)
// op 1: restrict (src fine -> dst coarse)
// params: kGenParamFloats floats in the order of GenWeights
// mask: null, or the 0/1 Dirichlet vertex mask of dst
PFH_EXPORT int pfh_transfer_general(int op, int R, const float* params,
                                    const float* src_v, const float* src_m,
                                    float* dst_v, float* dst_m,
                                    const float* mask, int F, int nyc, int nxc,
                                    int accumulate, void* stream) {
  GenWeights W;
  float* dst = reinterpret_cast<float*>(&W);
  for (int k = 0; k < kGenParamFloats; ++k) dst[k] = params[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 3:
      return launch<3>(op, W, src_v, src_m, dst_v, dst_m, mask, F, nyc, nxc, accumulate, s);
    case 5:
      return launch<5>(op, W, src_v, src_m, dst_v, dst_m, mask, F, nyc, nxc, accumulate, s);
    case 7:
      return launch<7>(op, W, src_v, src_m, dst_v, dst_m, mask, F, nyc, nxc, accumulate, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

PFH_EXPORT int pfh_transfer_general_param_floats() { return kGenParamFloats; }
