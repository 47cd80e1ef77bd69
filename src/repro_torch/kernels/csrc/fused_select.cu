// One construction step for all m ants, fused: gather row cur[a] of tau and
// eta, weight tau^alpha * eta^beta, mask visited and phantom (>= n_actual)
// cities, apply the per-mode transform, take the first arg-max.
//
// Replaces repro/kernels/fused_select.py::fused_select (_fused_kernel),
// with its int8/bf16 payload epilogue (quant="int8"/"bf16",
// fused_select.py:52-80).  The Pallas kernel gathers rows with one-hot MXU
// matmuls because a TPU kernel cannot gather dynamically; here each block
// reads its ant's rows directly.
// Bound: bytes -- 4 + 4 (tau, eta) + 1 (visited) + 4 (draw) bytes per
// (ant, city), ~13 MB per step at n = m = 1002, ~3.9 us at 3.35 TB/s; an
// int8 payload reads 1 byte of tau (+ one scale per ant), bf16 2 bytes.
// The step runs n-1 times an iteration, so launch overhead is of the same
// order.
// Design: one block per ant; threads stride over the city axis (coalesced
// row reads) keeping a running (value, index), then one block arg-max with
// the lowest-index tie rule.  The (m, n) weight matrix never exists.  The
// payload type is a template parameter: int8 converts exactly to float and
// multiplies by the row's scale (read once per block), the reference's
// "gather, then scale"; bf16 widens exactly.  Scale is constant along the
// row, so both equal dequantising the whole matrix first, bit for bit.
#include <cuda_bf16.h>
#include <cstdint>

#include "aco_common.cuh"

namespace {

constexpr int kBlock = 256;

// tau payload -> float32 (the dequant epilogue; identity for float32).
__device__ __forceinline__ float load_tau(const float* row, int j, float) {
  return row[j];
}
__device__ __forceinline__ float load_tau(const __nv_bfloat16* row, int j,
                                          float) {
  return __bfloat162float(row[j]);
}
__device__ __forceinline__ float load_tau(const int8_t* row, int j,
                                          float scale) {
  return __fmul_rn((float)row[j], scale);
}

template <typename T, int MODE>
__global__ void fused_select_kernel(const T* __restrict__ tau,
                                    const float* __restrict__ scale,
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
  const T* trow = tau + (long long)(row_ok ? c : 0) * n;
  const float srow = scale != nullptr ? scale[row_ok ? c : 0] : 1.0f;
  const float* erow = eta + (long long)(row_ok ? c : 0) * n;
  const long long base = (long long)a * n;
  aco::ArgMax best = aco::ArgMax::empty();
  for (int j = threadIdx.x; j < n; j += kBlock) {
    const float w =
        row_ok ? aco::choice(load_tau(trow, j, srow), erow[j], alpha, beta)
               : 0.0f;
    const bool keep = visited[base + j] == 0 && j < n_act;
    best.take(aco::transform<MODE>(w, keep, rand[base + j]), j);
  }
  best = aco::block_argmax<kBlock>(best);
  if (threadIdx.x == 0) out[a] = best.idx == INT_MAX ? 0 : best.idx;
}

template <typename T, int MODE>
void launch(const T* tau, const float* scale, const float* eta, int n_rows,
            const int* cur, const unsigned char* visited, const float* rand,
            int* out, int m, int n, float alpha, float beta, int n_act,
            cudaStream_t s) {
  fused_select_kernel<T, MODE><<<m, kBlock, 0, s>>>(
      tau, scale, eta, n_rows, cur, visited, rand, out, n, alpha, beta,
      n_act);
}

template <typename T>
int launch_mode(const T* tau, const float* scale, const float* eta,
                int n_rows, const int* cur, const unsigned char* visited,
                const float* rand, int* out, int m, int n, float alpha,
                float beta, int mode, int n_act, cudaStream_t s) {
  switch (mode) {
    case aco::kIRoulette:
      launch<T, aco::kIRoulette>(tau, scale, eta, n_rows, cur, visited, rand,
                                 out, m, n, alpha, beta, n_act, s);
      break;
    case aco::kGumbel:
      launch<T, aco::kGumbel>(tau, scale, eta, n_rows, cur, visited, rand,
                              out, m, n, alpha, beta, n_act, s);
      break;
    case aco::kGreedy:
      launch<T, aco::kGreedy>(tau, scale, eta, n_rows, cur, visited, rand,
                              out, m, n, alpha, beta, n_act, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// tau, eta: (n_rows, n) row-major; cur: (m,); visited, rand: (m, n).
extern "C" int aco_fused_select(const float* tau, const float* eta,
                                int n_rows, const int* cur,
                                const unsigned char* visited,
                                const float* rand, int* out, int m, int n,
                                float alpha, float beta, int mode,
                                int n_actual, void* stream) {
  if (m == 0) return 0;
  return launch_mode<float>(tau, nullptr, eta, n_rows, cur, visited, rand,
                            out, m, n, alpha, beta, mode, n_actual,
                            static_cast<cudaStream_t>(stream));
}

// The quantised payload: payload 1 = int8 tau with its (n_rows, 1) float32
// scale, 2 = bfloat16 tau (scale unused).
extern "C" int aco_fused_select_quant(const void* tau, int payload,
                                      const float* scale, const float* eta,
                                      int n_rows, const int* cur,
                                      const unsigned char* visited,
                                      const float* rand, int* out, int m,
                                      int n, float alpha, float beta,
                                      int mode, int n_actual, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  if (payload == 1) {
    if (scale == nullptr) return (int)cudaErrorInvalidValue;
    return launch_mode<int8_t>(static_cast<const int8_t*>(tau), scale, eta,
                               n_rows, cur, visited, rand, out, m, n, alpha,
                               beta, mode, n_actual, s);
  }
  if (payload == 2) {
    return launch_mode<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(tau), nullptr, eta, n_rows, cur,
        visited, rand, out, m, n, alpha, beta, mode, n_actual, s);
  }
  return (int)cudaErrorInvalidValue;
}
