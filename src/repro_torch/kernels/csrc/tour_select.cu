// The paper's Fig. 1 selection over precomputed choice rows: for each ant,
// mask visited and phantom (>= n_actual) cities, apply the per-mode
// transform to (row, uniform draw), and take the first arg-max.
//
// Replaces repro/kernels/tour_select.py::tour_select (_select_kernel).
// Bound: bytes -- 4 (row) + 1 (visited) + 4 (draw) bytes per (ant, city),
// ~9 MB per step at n = m = 1002, ~2.7 us at 3.35 TB/s; n-1 launches an
// iteration, so launch overhead is of the same order.
// Design: one block per ant; threads stride over the ant's row (coalesced
// reads) keeping a running (value, index), then one block arg-max with the
// lowest-index tie rule.  The instance axis (the reference's vmapped
// kernel): a (batch, m, n) stack is batch * m blocks, block r serving ant
// r % m of instance r / m with that instance's n_actual; the blocks of an
// inactive instance write 0 and return.  A single (m, n) is batch 1.
#include "aco_common.cuh"

namespace {

constexpr int kBlock = 256;

template <int MODE>
__global__ void tour_select_kernel(const float* __restrict__ rows,
                                   const unsigned char* __restrict__ visited,
                                   const float* __restrict__ rand,
                                   int* __restrict__ out, int m, int n,
                                   int n_act, const int* __restrict__ n_arr,
                                   const unsigned char* __restrict__ active) {
  const int b = blockIdx.x / m;
  if (active != nullptr && active[b] == 0) {
    if (threadIdx.x == 0) out[blockIdx.x] = 0;
    return;
  }
  if (n_arr != nullptr) n_act = n_arr[b];
  const long long base = (long long)blockIdx.x * n;
  aco::ArgMax best = aco::ArgMax::empty();
  for (int j = threadIdx.x; j < n; j += kBlock) {
    const bool keep = visited[base + j] == 0 && j < n_act;
    best.take(aco::transform<MODE>(rows[base + j], keep, rand[base + j]), j);
  }
  best = aco::block_argmax<kBlock>(best);
  if (threadIdx.x == 0) out[blockIdx.x] = best.idx == INT_MAX ? 0 : best.idx;
}

}  // namespace

// rows, rand: (batch, m, n) float32; visited: (batch, m, n) bytes; out:
// (batch, m).  n_actual: every instance's real-city count, or n_arr
// (batch,) on the device with each instance's; active (batch,) bytes or
// null.
extern "C" int aco_tour_select(const float* rows, const unsigned char* visited,
                               const float* rand, int* out, int batch, int m,
                               int n, int mode, int n_actual, const int* n_arr,
                               const unsigned char* active, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (long long)batch * m;
  if (blocks == 0) return 0;
  if (blocks < 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case aco::kIRoulette:
      tour_select_kernel<aco::kIRoulette><<<(int)blocks, kBlock, 0, s>>>(
          rows, visited, rand, out, m, n, n_actual, n_arr, active);
      break;
    case aco::kGumbel:
      tour_select_kernel<aco::kGumbel><<<(int)blocks, kBlock, 0, s>>>(
          rows, visited, rand, out, m, n, n_actual, n_arr, active);
      break;
    case aco::kGreedy:
      tour_select_kernel<aco::kGreedy><<<(int)blocks, kBlock, 0, s>>>(
          rows, visited, rand, out, m, n, n_actual, n_arr, active);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
