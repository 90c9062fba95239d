// The parameter block and cell layout shared by the crossed-P1 kernels: the
// gather J.v (fem_jvp.cuh), the tile J.v and sweep (fem_tile.cuh), the
// residual (fem_residual.cuh) and the physics headers (phys_*.cuh).
//
// Layout: v planes [F, ny+1, nx+1] (vertices), m planes [F, ny, nx] (cell
// centres), unpadded storage. Cell slots 0..4 are SW, SE, NE, NW and the
// centre C; triangles S (SW, SE, C), E (SE, NE, C), N (NW, NE, C) and
// W (SW, NW, C), as fem/grid.py numbers them.
#pragma once

#include "common.cuh"

namespace pfh {

constexpr int kMaxQ = 4;
constexpr int kMaxConst = 12;

struct JvpParams {
  float Bq[4][kMaxQ][5];   // basis values at quadrature points
  float Gs[4][5][2];       // physical basis gradients per triangle
  float WB[4][kMaxQ][5];   // weight * basis
  float WGx[4][kMaxQ][5];  // weight * d/dx basis
  float WGy[4][kMaxQ][5];  // weight * d/dy basis
  float k[kMaxConst];      // physics constants, in the physics' own order
  float dt;
};

constexpr int kJvpParamFloats = sizeof(JvpParams) / sizeof(float);

// Host side: the block from kJvpParamFloats floats in the order of
// JvpParams (Bq, Gs, WB, WGx, WGy zero-padded to kMaxQ points, the
// constants padded to kMaxConst, then dt).
inline JvpParams load_params(const float* params) {
  JvpParams P;
  float* dst = reinterpret_cast<float*>(&P);
  for (int i = 0; i < kJvpParamFloats; ++i) dst[i] = params[i];
  return P;
}

// Whether the physics' tangent also reads the state's gradient at the point
// (Phys::kStateGrad, false where the physics does not say): for such a
// physics the bodies form each state plane's gradient in each triangle from
// the slots they hold, as they form the direction's, let Phys::tri make the
// triangle's coefficients from it once, and pass those to Phys::tangent.
// Every other physics' code is left as it was.
template <class Phys, class = void>
struct ReadsStateGrad {
  static constexpr bool value = false;
};
template <class Phys>
struct ReadsStateGrad<Phys, decltype(void(Phys::kStateGrad))> {
  static constexpr bool value = Phys::kStateGrad;
};
template <class Phys>
constexpr bool kReadsStateGrad = ReadsStateGrad<Phys>::value;

// The triangle's coefficients the tangent takes: Phys::Tri, or nothing.
struct NoTri {};
template <class Phys, bool = kReadsStateGrad<Phys>>
struct TriOf {
  using type = NoTri;
};
template <class Phys>
struct TriOf<Phys, true> {
  using type = typename Phys::Tri;
};

// The gradient (ugx, ugy) of each of the NS state planes in triangle t of a
// cell with slot values wc, from the slots' differences to the centre (slot
// 4, in every triangle): the same function, since a triangle's basis
// gradients sum to zero, without the cancellation of slot values near each
// other (a state near +-1 whose gradient is small; at bench3's 7^2 level the
// plain sum loses 1e-4 of the J.v's largest entry in f32). The plain
// version forms it so too (fem/assembly.py ``_eval_qp(centred=True)``).
template <int NS>
__device__ __forceinline__ void state_grad(const JvpParams& P, int t,
                                           const float (&wc)[NS][5],
                                           float (&ugx)[NS], float (&ugy)[NS]) {
#pragma unroll
  for (int f = 0; f < NS; ++f) ugx[f] = ugy[f] = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int f = 0; f < NS; ++f) {
      const float d = wc[f][s] - wc[f][4];
      ugx[f] += P.Gs[t][s][0] * d;
      ugy[f] += P.Gs[t][s][1] * d;
    }
  }
}

// slots of each triangle as a bit mask (S, E, N, W; centre slot 4 in all)
__host__ __device__ constexpr bool slot_in_tri(int t, int s) {
  return (((t == 0) ? 0b10011u : (t == 1) ? 0b10110u
           : (t == 2) ? 0b11100u : 0b11001u) >> s) & 1u;
}

// The 5 slot values (SW, SE, NE, NW, C) of field plane (pv, pm) in cell (y, x).
template <class Ld = LoadRO>
__device__ __forceinline__ void load_slots(const float* __restrict__ pv,
                                           const float* __restrict__ pm,
                                           int y, int x, int nx, float out[5]) {
  const int nvx = nx + 1;
  out[0] = Ld::ld(pv + y * nvx + x);
  out[1] = Ld::ld(pv + y * nvx + x + 1);
  out[2] = Ld::ld(pv + (y + 1) * nvx + x + 1);
  out[3] = Ld::ld(pv + (y + 1) * nvx + x);
  out[4] = Ld::ld(pm + y * nx + x);
}

}  // namespace pfh
