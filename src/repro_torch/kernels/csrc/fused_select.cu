// One construction step for all m ants, fused: gather row cur[a] of tau and
// eta, weight tau^alpha * eta^beta, mask visited and phantom (>= n_actual)
// cities, apply the per-mode transform, take the first arg-max.
//
// Replaces repro/kernels/fused_select.py::fused_select (_fused_kernel, fp32
// body; the int8/bf16 dequant epilogue is not ported yet).  The Pallas
// kernel gathers rows with one-hot MXU matmuls because a TPU kernel cannot
// gather dynamically; here each block reads its ant's rows directly.
// Bound: bytes -- 4 + 4 (tau, eta) + 1 (visited) + 4 (draw) bytes per
// (ant, city), ~13 MB per step at n = m = 1002, ~3.9 us at 3.35 TB/s.  The
// step runs n-1 times an iteration, so launch overhead is of the same order.
// Design: one block per ant; threads stride over the city axis (coalesced
// row reads) keeping a running (value, index), then one block arg-max with
// the lowest-index tie rule.  The (m, n) weight matrix never exists.
#include "aco_common.cuh"

namespace {

constexpr int kBlock = 256;

template <int MODE>
__global__ void fused_select_kernel(const float* __restrict__ tau,
                                    const float* __restrict__ eta,
                                    int n_rows, const int* __restrict__ cur,
                                    const unsigned char* __restrict__ visited,
                                    const float* __restrict__ rand,
                                    int* __restrict__ out, int n, float alpha,
                                    float beta, int n_act) {
  const int a = blockIdx.x;
  const int c = cur[a];
  // A current city outside [0, n_rows) gathers a zero row, as the
  // reference's one-hot gather does.
  const bool row_ok = c >= 0 && c < n_rows;
  const float* trow = tau + (long long)(row_ok ? c : 0) * n;
  const float* erow = eta + (long long)(row_ok ? c : 0) * n;
  const long long base = (long long)a * n;
  aco::ArgMax best = aco::ArgMax::empty();
  for (int j = threadIdx.x; j < n; j += kBlock) {
    const float w = row_ok ? aco::choice(trow[j], erow[j], alpha, beta) : 0.0f;
    const bool keep = visited[base + j] == 0 && j < n_act;
    best.take(aco::transform<MODE>(w, keep, rand[base + j]), j);
  }
  best = aco::block_argmax<kBlock>(best);
  if (threadIdx.x == 0) out[a] = best.idx == INT_MAX ? 0 : best.idx;
}

template <int MODE>
void launch(const float* tau, const float* eta, int n_rows, const int* cur,
            const unsigned char* visited, const float* rand, int* out, int m,
            int n, float alpha, float beta, int n_act, cudaStream_t s) {
  fused_select_kernel<MODE><<<m, kBlock, 0, s>>>(
      tau, eta, n_rows, cur, visited, rand, out, n, alpha, beta, n_act);
}

}  // namespace

// tau, eta: (n_rows, n) row-major; cur: (m,); visited, rand: (m, n).
extern "C" int aco_fused_select(const float* tau, const float* eta,
                                int n_rows, const int* cur,
                                const unsigned char* visited,
                                const float* rand, int* out, int m, int n,
                                float alpha, float beta, int mode,
                                int n_actual, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  switch (mode) {
    case aco::kIRoulette:
      launch<aco::kIRoulette>(tau, eta, n_rows, cur, visited, rand, out, m, n,
                              alpha, beta, n_actual, s);
      break;
    case aco::kGumbel:
      launch<aco::kGumbel>(tau, eta, n_rows, cur, visited, rand, out, m, n,
                           alpha, beta, n_actual, s);
      break;
    case aco::kGreedy:
      launch<aco::kGreedy>(tau, eta, n_rows, cur, visited, rand, out, m, n,
                           alpha, beta, n_actual, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
