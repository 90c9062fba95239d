// The host side of the V-cycle chain kernels (vcycle_chain.cuh) that every
// physics shares: the size of a level's record, and its packing from the
// plan's operands (ops/vcycle_chain.ChainPlan), once per multigrid build.

#include <cstring>

#include "vcycle_chain.cuh"

// The bytes of one ChainLevel record.
PFH_EXPORT int pfh_vcycle_chain_level_bytes() {
  return static_cast<int>(sizeof(pfh::ChainLevel));
}

// Packs one level into dst (pfh_vcycle_chain_level_bytes() bytes, host
// memory). params: the level J.v's kJvpParamFloats floats, dt included;
// weights: H's kGenParamFloats floats for an odd ratio, or null; ptrs: the
// 21 device pointers xv, xm, rv, rm, zv, zm, av, am (x, r, z, A z), pv, pm
// (P^-1), wv, wm (the state), mask (the J.v's Dirichlet mask or null),
// partials (f64), bv, bm (the right-hand side), xin_v, xin_m (the ascent's
// iterate), tv, tm (the descent's restricted right-hand side), tmask (the
// transfer's mask or null); ints: F, ny, nx, n_sweeps, nb, n_groups, R, nyc,
// nxc; starts: n_groups + 1 ints or null (make_groups). R = 0 (with nyc = nxc
// = 0) packs a level with no pair: kernel V's coarsest (vcycle_fused.cuh).
PFH_EXPORT int pfh_vcycle_chain_pack(void* dst, const float* params,
                                     const float* weights,
                                     const void* const* ptrs, const int* ints,
                                     const int* starts) {
  const int F = ints[0], ny = ints[1], nx = ints[2], n_sweeps = ints[3];
  const int nb = ints[4], n_groups = ints[5], R = ints[6];
  const int nyc = ints[7], nxc = ints[8];
  const bool pair = R != 0;
  if (nb < 1 || nb > pfh::kLoopMaxSlots || n_sweeps < 0 ||
      (pair && R != 2 && R != 3 && R != 5 && R != 7) ||
      (pair && R != 2 && weights == nullptr) ||
      (pair ? (ny != R * nyc || nx != R * nxc) : (nyc != 0 || nxc != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  pfh::ChainLevel c;
  std::memset(&c, 0, sizeof(c));
  std::memcpy(&c.P, params, sizeof(c.P));
  if (weights != nullptr) std::memcpy(&c.W, weights, sizeof(c.W));
  auto f = [&](int i) { return static_cast<float*>(const_cast<void*>(ptrs[i])); };
  c.A = pfh::LoopArgs{f(0), f(1), f(2), f(3), f(4), f(5), f(6), f(7),
                      f(8), f(9), f(10), f(11), f(12),
                      static_cast<double*>(const_cast<void*>(ptrs[13])),
                      static_cast<long>(ny + 1) * (nx + 1),
                      static_cast<long>(ny) * nx, 0, ny, nx, n_sweeps, nb,
                      pfh::FieldGroups{}};
  if (!pfh::make_groups(F, n_groups, starts, &c.A.G))
    return static_cast<int>(cudaErrorInvalidValue);
  c.bv = f(14);
  c.bm = f(15);
  c.xv = f(16);
  c.xm = f(17);
  c.tv = f(18);
  c.tm = f(19);
  c.tmask = f(20);
  c.R = R;
  c.nyc = nyc;
  c.nxc = nxc;
  std::memcpy(dst, &c, sizeof(c));
  return 0;
}
