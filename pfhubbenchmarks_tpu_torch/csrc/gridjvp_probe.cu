// Kernel Q, gridjvp_probe: BM3's J.v as a grid of row blocks that scatter
// into their own partial vertex slabs, and the fold of the slabs. f32,
// fields (U, phi).
//
// Replaces the launch of tools/probes/gridjvp_probe.py:167 (its bodies
// `kernel`, :75-129, and `kernel_c`, :132-152): bench3's 350^2 grid as
// nb = ny / br row blocks of br = 50 cell rows. Row block i reads vertex rows
// [i br, i br + br] and cell rows [i br, (i+1) br), evaluates its cells and
// writes, without atomics, its own partial vertex slab (every vertex of its
// br + 1 rows, summed over the block's own cells only) and its cell rows of
// the centre output. The fold adds the slabs into the vertex plane: vertex
// row y sums the slabs of the blocks that hold it, in block order (the
// seam rows i br get two). Cases, as the probe's:
//   a: the pointwise tangent of BM3's physics (ACH::tangent, phys_ach.cuh);
//   b: identity physics, source = z and flux = grad z (the probe's :105-108);
//   c: the probe's kernel_c, jax.jvp of the whole block assembly, is the
//      same function as case a (it existed to reproduce a Mosaic abort);
//      CUDA has no in-kernel AD, so case c runs case a's body (the host
//      tool says so).
//
// Slab height: the TPU probe's BR + 8 rows per slab is Mosaic's 8-row
// alignment of a block; this kernel keeps br + 1 rows, the rows a block
// touches. Slabs: [F, nb (br + 1), nx + 1], block i at rows i (br + 1).
//
// Design: the gather form of fem_jvp.cuh inside each row block: a 2D launch
// grid (x: the block's output nodes, 128 a thread block; y: the row block),
// one thread per slab vertex or cell of the block, each summing the cells
// of its own row block that touch it in a fixed order; the fold is one
// thread per vertex. It is the third form of one J.v beside the gather
// (kernel G: every node once, the seam rows from both sides' cells) and
// the tiles (T12: shared-memory tiles, each triangle once, and a fold):
// here each seam row is evaluated twice, once per block, and the fold adds
// them, as the TPU's grid did.
//
// What bounds it on the H100: at 350^2 the state and tangent planes in
// (4 x 245,701 floats, 3.9 MB) and the slabs (2 x 7 x 51 x 351 floats)
// and the centre planes out: ~6 MB; the 4-point tangent makes it
// operation-bound (G's 2.574 us at ffc3), as kernel G.

#include "fem_jvp.cuh"
#include "phys_ach.cuh"

namespace pfh {

// The probe's case b: identity physics of the tangent (linear mass and
// stiffness), source = z and flux = grad z; reads no state.
struct Ident {
  static constexpr int NF = 2;
  static constexpr int NS = 1;
  __host__ __device__ static constexpr int state_field(int) { return 0; }
  __device__ __forceinline__ static void tangent(
      const JvpParams&, const float (&)[NS], const float (&d)[NF],
      const float (&gx)[NF], const float (&gy)[NF], float (&src)[NF],
      float (&fx)[NF], float (&fy)[NF]) {
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      src[f] = d[f];
      fx[f] = gx[f];
      fy[f] = gy[f];
    }
  }
};

template <class Phys, int NQ>
__global__ void __launch_bounds__(kThreads)
gridjvp_block_kernel(const JvpParams P, const float* __restrict__ wv,
                     const float* __restrict__ wm, const float* __restrict__ zv,
                     const float* __restrict__ zm, float* __restrict__ slab,
                     float* __restrict__ om, int ny, int nx, int br) {
  constexpr int NF = Phys::NF;
  const int nvx = nx + 1;
  const int blk = blockIdx.y;
  const int c0 = blk * br;  // the block's first cell row
  const long nsv = static_cast<long>(br + 1) * nvx;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nsv + static_cast<long>(br) * nx) return;
  float acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) acc[f] = 0.f;
  if (idx < nsv) {
    const int ly = static_cast<int>(idx / nvx);
    const int ix = static_cast<int>(idx % nvx);
    const int y = c0 + ly;
    // the block's cells that hold the vertex: SW of (y, ix), SE of
    // (y, ix-1) while y is above the block's last row; NE of (y-1, ix-1),
    // NW of (y-1, ix) below its first
    if (ly < br && ix < nx)
      cell_contrib<Phys, NQ, 0>(P, wv, wm, zv, zm, y, ix, ny, nx, acc);
    if (ly < br && ix > 0)
      cell_contrib<Phys, NQ, 1>(P, wv, wm, zv, zm, y, ix - 1, ny, nx, acc);
    if (ly > 0 && ix > 0)
      cell_contrib<Phys, NQ, 2>(P, wv, wm, zv, zm, y - 1, ix - 1, ny, nx, acc);
    if (ly > 0 && ix < nx)
      cell_contrib<Phys, NQ, 3>(P, wv, wm, zv, zm, y - 1, ix, ny, nx, acc);
    const long nslab = static_cast<long>(ny / br) * nsv;
#pragma unroll
    for (int f = 0; f < NF; ++f) slab[f * nslab + blk * nsv + idx] = acc[f];
  } else {
    const long c = idx - nsv;
    const int y = c0 + static_cast<int>(c / nx);
    const int ix = static_cast<int>(c % nx);
    cell_contrib<Phys, NQ, 4>(P, wv, wm, zv, zm, y, ix, ny, nx, acc);
    const long ncell = static_cast<long>(ny) * nx;
#pragma unroll
    for (int f = 0; f < NF; ++f) om[f * ncell + static_cast<long>(y) * nx + ix] = acc[f];
  }
}

__global__ void __launch_bounds__(kThreads)
gridjvp_fold_kernel(const float* __restrict__ slab, float* __restrict__ ov,
                    int F, int ny, int nx, int br) {
  const int nvx = nx + 1;
  const int nb = ny / br;
  const long nvert = static_cast<long>(ny + 1) * nvx;
  const long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= F * nvert) return;
  const int f = static_cast<int>(idx / nvert);
  const long node = idx % nvert;
  const int y = static_cast<int>(node / nvx);
  const int x = static_cast<int>(node % nvx);
  // blocks i with i br <= y <= i br + br, in order
  const int lo = y == 0 ? 0 : (y - 1) / br;
  const int hi = min(y / br, nb - 1);
  const long nsv = static_cast<long>(br + 1) * nvx;
  const float* s = slab + f * nb * nsv;
  float acc = 0.f;
  for (int i = lo; i <= hi; ++i)
    acc += __ldg(s + i * nsv + static_cast<long>(y - i * br) * nvx + x);
  ov[idx] = acc;
}

template <class Phys>
int launch_blocks(const JvpParams& P, int nq, dim3 grid, cudaStream_t s,
                  const float* wv, const float* wm, const float* zv,
                  const float* zm, float* slab, float* om, int ny, int nx,
                  int br) {
  if (nq == 4) {
    gridjvp_block_kernel<Phys, 4><<<grid, kThreads, 0, s>>>(P, wv, wm, zv, zm, slab,
                                                            om, ny, nx, br);
  } else if (nq == 3) {
    gridjvp_block_kernel<Phys, 3><<<grid, kThreads, 0, s>>>(P, wv, wm, zv, zm, slab,
                                                            om, ny, nx, br);
  } else if (nq == 1) {
    gridjvp_block_kernel<Phys, 1><<<grid, kThreads, 0, s>>>(P, wv, wm, zv, zm, slab,
                                                            om, ny, nx, br);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pfh

// identity: 0 for case a's tangent (ACH), 1 for case b's identity physics.
// params: the JvpParams block (fem_params.cuh) of the grid and BM3's
// constants. slab: [2, ny / br (br + 1), nx + 1]; om: [2, ny, nx].
PFH_EXPORT int pfh_gridjvp_probe(int identity, const float* params, int nq,
                                 const float* wv, const float* wm,
                                 const float* zv, const float* zm, float* slab,
                                 float* om, int ny, int nx, int br,
                                 void* stream) {
  if (br < 1 || ny % br != 0) return static_cast<int>(cudaErrorInvalidValue);
  const pfh::JvpParams P = pfh::load_params(params);
  const long n = static_cast<long>(br + 1) * (nx + 1) + static_cast<long>(br) * nx;
  const dim3 grid(pfh::blocks_for(n), ny / br);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return identity ? pfh::launch_blocks<pfh::Ident>(P, nq, grid, s, wv, wm, zv, zm,
                                                   slab, om, ny, nx, br)
                  : pfh::launch_blocks<pfh::ACH>(P, nq, grid, s, wv, wm, zv, zm,
                                                 slab, om, ny, nx, br);
}

PFH_EXPORT int pfh_gridjvp_fold(const float* slab, float* ov, int F, int ny,
                                int nx, int br, void* stream) {
  if (br < 1 || ny % br != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long n = static_cast<long>(F) * (ny + 1) * (nx + 1);
  pfh::gridjvp_fold_kernel<<<pfh::blocks_for(n), pfh::kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(slab, ov, F, ny,
                                                                 nx, br);
  return static_cast<int>(cudaGetLastError());
}
