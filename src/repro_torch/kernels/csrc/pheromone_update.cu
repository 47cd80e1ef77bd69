// Fused pheromone update: out = (1 - rho) * tau + sum_e w_e [frm_e = i][to_e = j]
// over a directed-edge stream; endpoints outside [0, n0) x [0, n1) (the -1
// padding) deposit nothing.  tau may be rectangular (n0, n1).
//
// Replaces repro/kernels/pheromone_update.py::pheromone_update
// (_update_kernel).  The Pallas kernel builds one-hot slabs per output tile
// and reduces them on the MXU (scatter-to-gather); on Hopper the paper's own
// winning version is native: evaporate every cell, then one thread per edge
// does an atomicAdd.
// Bound: bytes -- 8 bytes per cell (read tau, write out) + 12 per edge
// (frm, to, w); at n = m = 1002 (E = 2 m n) about 32 MB, ~9.6 us at 3.35 TB/s.
// Numerics: the evaporation product is rounded on its own (__fmul_rn, no
// FMA with the deposit), as the Pallas kernel and the plain version do.  A
// cell that gets at most one deposit (MMAS, the ACS deposit, AS with one
// ant) is therefore bitwise the plain version.  A cell with several
// deposits (AS with m ants) sums them in atomic order: ulp-close, and not
// reproducible from run to run.
#include "aco_common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void evaporate_kernel(const float* __restrict__ tau,
                                 float* __restrict__ out, long long total,
                                 float decay) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    out[i] = __fmul_rn(decay, tau[i]);
  }
}

__global__ void deposit_kernel(const int* __restrict__ frm,
                               const int* __restrict__ to,
                               const float* __restrict__ w,
                               float* __restrict__ out, long long n_edges,
                               int n0, int n1) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < n_edges; e += (long long)gridDim.x * blockDim.x) {
    const int f = frm[e], t = to[e];
    if (f >= 0 && f < n0 && t >= 0 && t < n1) {
      atomicAdd(out + (long long)f * n1 + t, w[e]);
    }
  }
}

}  // namespace

// decay = float32(1 - rho), rounded by the caller as JAX rounds it.
extern "C" int aco_pheromone_update(const float* tau, const int* frm,
                                    const int* to, const float* w, float* out,
                                    int n0, int n1, long long n_edges,
                                    float decay, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n0 * n1;
  if (total > 0) {
    evaporate_kernel<<<aco::grid_for(total, kBlock), kBlock, 0, s>>>(
        tau, out, total, decay);
  }
  if (n_edges > 0 && total > 0) {
    deposit_kernel<<<aco::grid_for(n_edges, kBlock), kBlock, 0, s>>>(
        frm, to, w, out, n_edges, n0, n1);
  }
  return (int)cudaGetLastError();
}
