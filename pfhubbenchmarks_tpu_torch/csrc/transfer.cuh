// The grid transfers of one output node and one field, as __device__
// functions: kernel D's (dyadic pairs, transfer.cu) and kernel H's (equal odd
// ratios R in {3, 5, 7}, transfer_general.cu). The kernels launch one thread
// per (field, output node) over them; a kernel that runs several levels in
// one launch calls the same bodies between its grid barriers, as kernel L
// calls jvp_node.
//
// Every body computes exactly what the plain versions of ops/transfer.py
// compute, term for term in their order: D's expressions as written (its
// products are by 0.5, exact, so a contraction to FMA gives the same bits),
// H's products and sums each one rounded __fmul_rn / __fadd_rn. So the
// kernels agree with the plain versions to the bit, whatever launch shape
// runs them.
//
// Planes are one field's [Y, X] arrays. D's bodies and H's prolongation read
// them through a load policy (common.cuh: LoadRO, or LoadCG for a plane
// written earlier in the same launch). H's restriction reads its fine planes
// through an accessor v(y, x) of global fine coordinates (TilePlane: a strip
// of rows staged in shared memory; LdPlane: the plane in device memory).
#pragma once

#include "common.cuh"

namespace pfh {
namespace xfer {

// ---------------------------------------------------------------------------
// kernel D: fine nx = 2 nxc, ny = 2 nyc
// ---------------------------------------------------------------------------

// P: fine vertex (Y, X) from the coarse vertex plane v [nyc+1, nxc+1] and
// centre plane m [nyc, nxc]
template <class Ld = LoadRO>
__device__ __forceinline__ float dyadic_prolong_vertex(
    const float* __restrict__ v, const float* __restrict__ m, int Y, int X,
    int nxc) {
  const int nvxc = nxc + 1;
  const int i = Y >> 1, j = X >> 1;
  if (!(Y & 1) && !(X & 1)) return Ld::ld(v + i * nvxc + j);
  if (!(Y & 1)) return 0.5f * (Ld::ld(v + i * nvxc + j) + Ld::ld(v + i * nvxc + j + 1));
  if (!(X & 1)) return 0.5f * (Ld::ld(v + i * nvxc + j) + Ld::ld(v + (i + 1) * nvxc + j));
  return Ld::ld(m + i * nxc + j);
}

// P: fine centre (y, x), the mean of its nearest coarse corner and the
// coarse centre of its cell
template <class Ld = LoadRO>
__device__ __forceinline__ float dyadic_prolong_centre(
    const float* __restrict__ v, const float* __restrict__ m, int y, int x,
    int nxc) {
  const int i = y >> 1, j = x >> 1;
  return 0.5f * (Ld::ld(v + (i + (y & 1)) * (nxc + 1) + j + (x & 1))
                 + Ld::ld(m + i * nxc + j));
}

// R = P^T: coarse vertex (I, J) from the fine planes v [2nyc+1, 2nxc+1] and
// m [2nyc, 2nxc], a gather over its fine neighbourhood
template <class Ld = LoadRO>
__device__ __forceinline__ float dyadic_restrict_vertex(
    const float* __restrict__ v, const float* __restrict__ m, int I, int J,
    int nyc, int nxc) {
  const int nvxf = 2 * nxc + 1, nxf = 2 * nxc;
  const int Y = 2 * I, X = 2 * J;
  float acc = Ld::ld(v + Y * nvxf + X);
  if (J < nxc) acc += 0.5f * Ld::ld(v + Y * nvxf + X + 1);
  if (J > 0) acc += 0.5f * Ld::ld(v + Y * nvxf + X - 1);
  if (I < nyc) acc += 0.5f * Ld::ld(v + (Y + 1) * nvxf + X);
  if (I > 0) acc += 0.5f * Ld::ld(v + (Y - 1) * nvxf + X);
  if (I < nyc && J < nxc) acc += 0.5f * Ld::ld(m + Y * nxf + X);
  if (I < nyc && J > 0) acc += 0.5f * Ld::ld(m + Y * nxf + X - 1);
  if (I > 0 && J < nxc) acc += 0.5f * Ld::ld(m + (Y - 1) * nxf + X);
  if (I > 0 && J > 0) acc += 0.5f * Ld::ld(m + (Y - 1) * nxf + X - 1);
  return acc;
}

// R: coarse centre (i, j): the fine vertex at its middle and half the sum of
// the four fine centres of its cell
template <class Ld = LoadRO>
__device__ __forceinline__ float dyadic_restrict_centre(
    const float* __restrict__ v, const float* __restrict__ m, int i, int j,
    int nxc) {
  const int nvxf = 2 * nxc + 1, nxf = 2 * nxc;
  const int y = 2 * i, x = 2 * j;
  const float sum4 = Ld::ld(m + y * nxf + x) + Ld::ld(m + y * nxf + x + 1)
                     + Ld::ld(m + (y + 1) * nxf + x) + Ld::ld(m + (y + 1) * nxf + x + 1);
  return Ld::ld(v + (y + 1) * nvxf + x + 1) + 0.5f * sum4;
}

// state injection: coarse vertex (I, J) = fine vertex (2I, 2J), coarse centre
// (i, j) = fine vertex (2i+1, 2j+1)
template <class Ld = LoadRO>
__device__ __forceinline__ float dyadic_inject_vertex(const float* __restrict__ v,
                                                      int I, int J, int nxc) {
  return Ld::ld(v + (2 * I) * (2 * nxc + 1) + 2 * J);
}

template <class Ld = LoadRO>
__device__ __forceinline__ float dyadic_inject_centre(const float* __restrict__ v,
                                                      int i, int j, int nxc) {
  return Ld::ld(v + (2 * i + 1) * (2 * nxc + 1) + 2 * j + 1);
}

// ---------------------------------------------------------------------------
// kernel H: fine nx = R nxc, ny = R nyc, R odd
// ---------------------------------------------------------------------------

constexpr int kMaxR = 7;

// The class tables of ops/transfer.py _general_params, f32 (host-built from
// _p1_weights, so the weights are the plain versions' to the bit).
struct GenWeights {
  float wv[kMaxR][kMaxR][5];  // fine vertex classes (py, px) over the slots
  float wm[kMaxR][kMaxR][5];  // fine centre classes
  float frac[kMaxR];          // px / R on the last row and column
  float one_minus[kMaxR];     // 1 - px / R
};

constexpr int kGenParamFloats = sizeof(GenWeights) / sizeof(float);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// P: fine vertex (vert) or centre (Y, X) of a fine grid R nyc x R nxc: the
// five slots (SW, SE, NW, NE corners, centre) of its coarse cell weighted by
// its class; on the last fine vertex row and column, 1-D interpolation along
// the coarse edge; the last corner copied.
template <int R, class Ld = LoadRO>
__device__ __forceinline__ float general_prolong_node(
    const GenWeights& W, const float* __restrict__ v, const float* __restrict__ m,
    bool vert, int Y, int X, int nyc, int nxc) {
  const int nvxc = nxc + 1, nyf = R * nyc, nxf = R * nxc;
  const int i = Y / R, py = Y - R * i;
  const int j = X / R, px = X - R * j;
  if (Y < nyf && X < nxf) {
    const float* w = vert ? W.wv[py][px] : W.wm[py][px];
    float val = mul(w[0], Ld::ld(v + i * nvxc + j));
    val = add(val, mul(w[1], Ld::ld(v + i * nvxc + j + 1)));
    val = add(val, mul(w[2], Ld::ld(v + (i + 1) * nvxc + j)));
    val = add(val, mul(w[3], Ld::ld(v + (i + 1) * nvxc + j + 1)));
    return add(val, mul(w[4], Ld::ld(m + i * nxc + j)));
  }
  if (Y == nyf && X < nxf)   // last fine row: along the top edge
    return add(mul(W.one_minus[px], Ld::ld(v + nyc * nvxc + j)),
               mul(W.frac[px], Ld::ld(v + nyc * nvxc + j + 1)));
  if (X == nxf && Y < nyf)   // last fine column: the right edge
    return add(mul(W.one_minus[py], Ld::ld(v + i * nvxc + nxc)),
               mul(W.frac[py], Ld::ld(v + (i + 1) * nvxc + nxc)));
  return Ld::ld(v + nyc * nvxc + nxc);   // the last corner
}

// Rows y0.. and columns x0.. of a fine plane, staged in shared memory with
// row stride kStride; read at global fine coordinates.
template <int kStride>
struct TilePlane {
  const float* s;
  int y0, x0;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return s[(y - y0) * kStride + (x - x0)];
  }
};

// acc += the fine nodes of coarse cell (ci, cj) that read its slot S (vertex
// classes, then centre classes, (py, px) row-major).
template <int R, int S, class Plane>
__device__ __forceinline__ float gather_cell(const GenWeights& W, const Plane& v,
                                             const Plane& m, int ci, int cj,
                                             float acc) {
#pragma unroll
  for (int py = 0; py < R; ++py)
#pragma unroll
    for (int px = 0; px < R; ++px)
      acc = add(acc, mul(W.wv[py][px][S], v(R * ci + py, R * cj + px)));
#pragma unroll
  for (int py = 0; py < R; ++py)
#pragma unroll
    for (int px = 0; px < R; ++px)
      acc = add(acc, mul(W.wm[py][px][S], m(R * ci + py, R * cj + px)));
  return acc;
}

// R = P^T: coarse vertex (I, J). It is slot SW of cell (I, J), SE of
// (I, J-1), NW of (I-1, J) and NE of (I-1, J-1); then the last fine row's and
// column's 1-D weights (1 - frac, then frac), then the last corner.
template <int R, class Plane>
__device__ __forceinline__ float general_restrict_vertex(
    const GenWeights& W, const Plane& v, const Plane& m, int I, int J, int nyc,
    int nxc) {
  const int nyf = R * nyc, nxf = R * nxc;
  float acc = 0.f;
  if (I < nyc && J < nxc) acc = gather_cell<R, 0>(W, v, m, I, J, acc);
  if (I < nyc && J > 0) acc = gather_cell<R, 1>(W, v, m, I, J - 1, acc);
  if (I > 0 && J < nxc) acc = gather_cell<R, 2>(W, v, m, I - 1, J, acc);
  if (I > 0 && J > 0) acc = gather_cell<R, 3>(W, v, m, I - 1, J - 1, acc);
  if (I == nyc) {   // the last fine row reads the top edge
    if (J < nxc)
#pragma unroll
      for (int p = 0; p < R; ++p)
        acc = add(acc, mul(W.one_minus[p], v(nyf, R * J + p)));
    if (J > 0)
#pragma unroll
      for (int p = 0; p < R; ++p)
        acc = add(acc, mul(W.frac[p], v(nyf, R * (J - 1) + p)));
  }
  if (J == nxc) {   // the last fine column reads the right edge
    if (I < nyc)
#pragma unroll
      for (int p = 0; p < R; ++p)
        acc = add(acc, mul(W.one_minus[p], v(R * I + p, nxf)));
    if (I > 0)
#pragma unroll
      for (int p = 0; p < R; ++p)
        acc = add(acc, mul(W.frac[p], v(R * (I - 1) + p, nxf)));
  }
  if (I == nyc && J == nxc) acc = add(acc, v(nyf, nxf));
  return acc;
}

// A fine plane in device memory with row stride `stride`, read by Ld at
// global fine coordinates: H's restriction in a launch that wrote the plane
// earlier (the descend chain, vcycle_chain.cuh, with LoadCG).
template <class Ld>
struct LdPlane {
  const float* p;
  int stride;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return Ld::ld(p + static_cast<long>(y) * stride + x);
  }
};

// R: coarse centre (i, j), the fine nodes of its own cell
template <int R, class Plane>
__device__ __forceinline__ float general_restrict_centre(
    const GenWeights& W, const Plane& v, const Plane& m, int i, int j) {
  return gather_cell<R, 4>(W, v, m, i, j, 0.f);
}

}  // namespace xfer
}  // namespace pfh
