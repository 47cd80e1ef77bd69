// Sparse candidate-page selection for all m ants: gather the tabu bit and
// the draw at each ant's K candidate cities, weight the page
// tau^alpha * eta^beta, mask, apply the per-mode transform, take the first
// arg-max over the K page positions (pos), and report whether any
// unvisited candidate has positive weight (have).
//
// Replaces repro/kernels/sparse_select.py::sparse_select (_sparse_kernel),
// with its int8/bf16 payload epilogue (quant="int8"/"bf16",
// sparse_select.py:79-85).  The Pallas kernel gathers visited/rand with a
// one-hot batched dot over city tiles because a TPU kernel cannot gather;
// here each lane reads visited[a, cand] and rand[a, cand] directly.
// Bound: bytes -- per (ant, page position) it reads the id (4), tau (4, 2
// or 1, + a 4-byte scale for int8) and eta (4) contiguously, and two
// scattered 32-byte sectors for the gathered tabu byte and draw.  At
// m = 64, K = 20 that is about 0.1 MB, tens of nanoseconds at 3.35 TB/s:
// the launch itself is the cost.
// Design: one warp per ant, kWarps ants per block; lanes stride over the K
// positions (K <= 36 on the sparse route, one or two per lane), keep a
// running (value, index) with the lowest-index tie rule of the dense
// kernels (aco::ArgMax) and a partial sum of w * mask, then one warp
// shuffle reduction.  Ids < 0 are padding, as in the reference oracle:
// they gather visited 0 and draw 0 and keep their page's own tau and eta.
// Ids >= n are not valid input; they are read as padding too, so that no
// load leaves the row.  The int8 payload converts exactly to float and
// multiplies by its per-element scale with __fmul_rn (the oracle's
// dequantise-then-select); bf16 widens exactly.
#include <cuda_bf16.h>
#include <cstdint>

#include "aco_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_tau(const float* tau, long long i,
                                          const float*) {
  return tau[i];
}
__device__ __forceinline__ float load_tau(const __nv_bfloat16* tau,
                                          long long i, const float*) {
  return __bfloat162float(tau[i]);
}
__device__ __forceinline__ float load_tau(const int8_t* tau, long long i,
                                          const float* scale) {
  return __fmul_rn((float)tau[i], scale[i]);
}

template <typename T, int MODE>
__global__ void sparse_select_kernel(const T* __restrict__ tau,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ eta,
                                     const int* __restrict__ cand,
                                     const unsigned char* __restrict__ visited,
                                     const float* __restrict__ rand,
                                     int* __restrict__ pos,
                                     int* __restrict__ have, int m, int k,
                                     int n, float alpha, float beta) {
  const int lane = threadIdx.x & 31;
  const int a = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (a >= m) return;  // a whole warp leaves together
  const long long page = (long long)a * k;
  const long long row = (long long)a * n;
  aco::ArgMax best = aco::ArgMax::empty();
  float sum = 0.0f;
  for (int j = lane; j < k; j += 32) {
    const int c = cand[page + j];
    const bool real = c >= 0 && c < n;
    const bool keep = !real || visited[row + c] == 0;
    const float u = real ? rand[row + c] : 0.0f;
    const float w =
        aco::choice(load_tau(tau, page + j, scale), eta[page + j], alpha,
                    beta);
    best.take(aco::transform<MODE>(w, keep, u), j);
    sum = __fadd_rn(sum, __fmul_rn(w, keep ? 1.0f : 0.0f));
  }
  // Every term of `sum` is >= 0, +inf or NaN, so whether it ends > 0 does
  // not depend on the order of the additions.
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(kFull, best.val, off);
    const int i = __shfl_down_sync(kFull, best.idx, off);
    best.take(v, i);
    sum = __fadd_rn(sum, __shfl_down_sync(kFull, sum, off));
  }
  if (lane == 0) {
    pos[a] = best.idx == INT_MAX ? 0 : best.idx;
    have[a] = sum > 0.0f ? 1 : 0;
  }
}

template <typename T>
int launch_mode(const T* tau, const float* scale, const float* eta,
                const int* cand, const unsigned char* visited,
                const float* rand, int* pos, int* have, int m, int k, int n,
                float alpha, float beta, int mode, cudaStream_t s) {
  const int grid = (m + kWarps - 1) / kWarps;
  const int block = kWarps * 32;
  switch (mode) {
    case aco::kIRoulette:
      sparse_select_kernel<T, aco::kIRoulette><<<grid, block, 0, s>>>(
          tau, scale, eta, cand, visited, rand, pos, have, m, k, n, alpha,
          beta);
      break;
    case aco::kGumbel:
      sparse_select_kernel<T, aco::kGumbel><<<grid, block, 0, s>>>(
          tau, scale, eta, cand, visited, rand, pos, have, m, k, n, alpha,
          beta);
      break;
    case aco::kGreedy:
      sparse_select_kernel<T, aco::kGreedy><<<grid, block, 0, s>>>(
          tau, scale, eta, cand, visited, rand, pos, have, m, k, n, alpha,
          beta);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// tau, eta, cand: (m, k) row-major; visited, rand: (m, n); pos, have: (m,).
extern "C" int aco_sparse_select(const float* tau, const float* eta,
                                 const int* cand,
                                 const unsigned char* visited,
                                 const float* rand, int* pos, int* have,
                                 int m, int k, int n, float alpha, float beta,
                                 int mode, void* stream) {
  if (m == 0) return 0;
  return launch_mode<float>(tau, nullptr, eta, cand, visited, rand, pos,
                            have, m, k, n, alpha, beta, mode,
                            static_cast<cudaStream_t>(stream));
}

// The quantised page payload: payload 1 = int8 tau with its (m, k) float32
// scale, 2 = bfloat16 tau (scale unused).
extern "C" int aco_sparse_select_quant(const void* tau, int payload,
                                       const float* scale, const float* eta,
                                       const int* cand,
                                       const unsigned char* visited,
                                       const float* rand, int* pos,
                                       int* have, int m, int k, int n,
                                       float alpha, float beta, int mode,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (payload == 1) {
    if (scale == nullptr) return (int)cudaErrorInvalidValue;
    return launch_mode<int8_t>(static_cast<const int8_t*>(tau), scale, eta,
                               cand, visited, rand, pos, have, m, k, n,
                               alpha, beta, mode, s);
  }
  if (payload == 2) {
    return launch_mode<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(tau), nullptr, eta, cand, visited,
        rand, pos, have, m, k, n, alpha, beta, mode, s);
  }
  return (int)cudaErrorInvalidValue;
}
