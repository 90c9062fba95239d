// Kernel C, lmr_step: one local-minimal-residual update, in place, f32.
//
//   alpha_g = <Az, r>_g / <Az, Az>_g   (0 when <Az, Az>_g == 0)
//   x += alpha_g z,   r -= alpha_g Az   on the fields of group g
//
// over the v and m planes together (a 3D state has v planes only: ncell = 0
// and null m pointers, as in the 3D sweeps of
// pfhubbenchmarks_tpu/ops/pallas3d.py). Without field groups there is one group
// of all fields, a single alpha. Replaces _lmr_alpha (with or without its
// groups) and the axpys of the LMR sweep body in
// pfhubbenchmarks_tpu/ops/pallas_vcycle.py (make_fused_vcycle's sweeps,
// :311-325 and :503-540), of make_pallas_lmr_sweep_loop and
// make_pallas_lmr_sweep (ops/pallas_residual.py), and the partial dots of
// make_tiled_lmr_sweep (ops/pallas_tiled.py), whose alpha is formed outside
// its kernel as stage 2 does here.
//
// Design: a deterministic two-stage reduction. Stage 1 (lmr_partials): a
// grid of nb x G blocks, nb chosen from the vector length alone; block
// (b, g) reduces a fixed strided subset of group g's entries (its v planes,
// then its m planes) into two double partials with a fixed shared-memory
// tree. Stage 2 (lmr_update): threads 0..G-1 of every block sum their
// group's partials in index order and form alpha_g (so every block computes
// the same alphas), then the block applies the two axpys. No atomics: the
// same inputs give the same bits on every run, and with one group the
// partials, their order and the result are those of the ungrouped kernel.
// The alphas stay in device memory (also written to alpha_out for
// inspection) and never go to the host.
//
// What bounds it on the H100: ~0.3 MB read and 0.3 MB written per step at
// BM1's 100^2 (0.9 MB and 0.5 MB at BM2's six fields), L2-resident; the
// step is two launches of latency, which the design accepts in exchange for
// determinism without a grid-wide sync. On a gather level the sweeps run
// both stages inside kernel L (lmr_loop.cuh), with grid barriers and C's
// partition; C itself serves the tiled sweep loop, the sharded smoother and
// the launch sequence L is held against.

#include "common.cuh"

namespace {

constexpr int kRedThreads = 256;

__global__ void __launch_bounds__(kRedThreads)
lmr_partials_kernel(const float* __restrict__ azv, const float* __restrict__ azm,
                    const float* __restrict__ rv, const float* __restrict__ rm,
                    long nvert, long ncell, const pfh::FieldGroups G,
                    double* __restrict__ partials) {
  __shared__ double s_num[kRedThreads];
  __shared__ double s_den[kRedThreads];
  const int g = blockIdx.y;
  const long f0 = G.start[g];
  const long nf = G.start[g + 1] - f0;
  const long nv = nf * nvert;           // the group's v entries come first
  const long n = nv + nf * ncell;
  const float* av = azv + f0 * nvert;
  const float* am = azm + f0 * ncell;
  const float* qv = rv + f0 * nvert;
  const float* qm = rm + f0 * ncell;
  double num = 0.0, den = 0.0;
  for (long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * blockDim.x) {
    const double a = i < nv ? __ldg(av + i) : __ldg(am + (i - nv));
    num += a * (i < nv ? __ldg(qv + i) : __ldg(qm + (i - nv)));
    den += a * a;
  }
  s_num[threadIdx.x] = num;
  s_den[threadIdx.x] = den;
  __syncthreads();
  for (int stride = kRedThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_num[threadIdx.x] += s_num[threadIdx.x + stride];
      s_den[threadIdx.x] += s_den[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int nb = gridDim.x;
    partials[g * nb + blockIdx.x] = s_num[0];
    partials[(G.n + g) * nb + blockIdx.x] = s_den[0];
  }
}

__global__ void __launch_bounds__(pfh::kThreads)
lmr_update_kernel(const double* __restrict__ partials, int nb,
                  float* __restrict__ xv, float* __restrict__ xm,
                  float* __restrict__ rv, float* __restrict__ rm,
                  const float* __restrict__ zv, const float* __restrict__ zm,
                  const float* __restrict__ azv, const float* __restrict__ azm,
                  long nvert, long ncell, int F, const pfh::FieldGroups G,
                  float* __restrict__ alpha_out) {
  __shared__ float s_alpha[pfh::kMaxGroups];
  if (threadIdx.x < G.n) {
    const int g = threadIdx.x;
    double num = 0.0, den = 0.0;
    for (int b = 0; b < nb; ++b) {
      num += partials[g * nb + b];
      den += partials[(G.n + g) * nb + b];
    }
    s_alpha[g] = den > 0.0 ? static_cast<float>(num / den) : 0.0f;
    if (blockIdx.x == 0) alpha_out[g] = s_alpha[g];
  }
  __syncthreads();
  const long nv = F * nvert;
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < nv) {
    const float alpha = s_alpha[pfh::group_of(G, static_cast<int>(i / nvert))];
    xv[i] += alpha * zv[i];
    rv[i] -= alpha * azv[i];
  } else if (i < nv + F * ncell) {
    const long j = i - nv;
    const float alpha = s_alpha[pfh::group_of(G, static_cast<int>(j / ncell))];
    xm[j] += alpha * zm[j];
    rm[j] -= alpha * azm[j];
  }
}

}  // namespace

// nvert, ncell: the entries of one field's v and m planes; starts: n_groups
// + 1 host ints (pfh::make_groups), or null for one group; partials: device
// scratch of 2 * n_groups * nb doubles, nb in [1, 64]; alpha_out: n_groups
// device floats.
//
// pfh_lmr_partials and pfh_lmr_update are the two stages alone, for the
// sharded smoother (ops/lmr.py, parallel/halo_smoother.py), which adds the
// shards' partials between them (its all-reduce); pfh_lmr_step is both.
PFH_EXPORT int pfh_lmr_partials(const float* azv, const float* azm,
                                const float* rv, const float* rm, long nvert,
                                long ncell, int F, int n_groups,
                                const int* starts, double* partials, int nb,
                                void* stream) {
  pfh::FieldGroups G;
  if (nb < 1 || nb > 64 || !pfh::make_groups(F, n_groups, starts, &G))
    return static_cast<int>(cudaErrorInvalidValue);
  lmr_partials_kernel<<<dim3(nb, G.n), kRedThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      azv, azm, rv, rm, nvert, ncell, G, partials);
  return static_cast<int>(cudaGetLastError());
}

PFH_EXPORT int pfh_lmr_update(const double* partials, int nb, float* xv,
                              float* xm, float* rv, float* rm, const float* zv,
                              const float* zm, const float* azv,
                              const float* azm, long nvert, long ncell, int F,
                              int n_groups, const int* starts,
                              float* alpha_out, void* stream) {
  pfh::FieldGroups G;
  if (nb < 1 || nb > 64 || !pfh::make_groups(F, n_groups, starts, &G))
    return static_cast<int>(cudaErrorInvalidValue);
  lmr_update_kernel<<<pfh::blocks_for(F * (nvert + ncell)), pfh::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      partials, nb, xv, xm, rv, rm, zv, zm, azv, azm, nvert, ncell, F, G,
      alpha_out);
  return static_cast<int>(cudaGetLastError());
}

PFH_EXPORT int pfh_lmr_step(float* xv, float* xm, float* rv, float* rm,
                            const float* zv, const float* zm, const float* azv,
                            const float* azm, long nvert, long ncell, int F,
                            int n_groups, const int* starts, double* partials,
                            int nb, float* alpha_out, void* stream) {
  const int err = pfh_lmr_partials(azv, azm, rv, rm, nvert, ncell, F, n_groups,
                                   starts, partials, nb, stream);
  if (err != 0) return err;
  return pfh_lmr_update(partials, nb, xv, xm, rv, rm, zv, zm, azv, azm, nvert,
                        ncell, F, n_groups, starts, alpha_out, stream);
}
