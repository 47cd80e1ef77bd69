// The paper's Choice kernel: out = tau^alpha * eta^beta elementwise over an
// (n0, n1) matrix, with rows and columns >= n_actual pinned to 0.
//
// Replaces repro/kernels/choice_info.py::choice_info (_choice_kernel).
// Bound: bytes -- 12 bytes per cell (two float reads, one float write) and
// at most a few multiplies; at n = 1002 that is 12 MB, ~3.6 us at 3.35 TB/s.
// Design: one grid-stride pass, 16-byte float4 loads and stores where the
// row width is a multiple of 4 and the pointers are 16-byte aligned.
#include <cstdint>

#include "aco_common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void choice_info_kernel(const float* __restrict__ tau,
                                   const float* __restrict__ eta,
                                   float* __restrict__ out, int n0, int n1,
                                   float alpha, float beta, int n_act) {
  const long long total = (long long)n0 * n1;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / n1), c = (int)(i % n1);
    const float v = aco::choice(tau[i], eta[i], alpha, beta);
    out[i] = (r < n_act && c < n_act) ? v : 0.0f;
  }
}

// n1 % 4 == 0 and 16-byte aligned pointers: one float4 per thread-step.
__global__ void choice_info_kernel_vec4(const float4* __restrict__ tau,
                                        const float4* __restrict__ eta,
                                        float4* __restrict__ out, int n0,
                                        int n1, float alpha, float beta,
                                        int n_act) {
  const long long total = (long long)n0 * n1 / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long e = 4 * i;
    const int r = (int)(e / n1), c = (int)(e % n1);
    const float4 t = tau[i], h = eta[i];
    const bool row_ok = r < n_act;
    float4 o;
    o.x = (row_ok && c + 0 < n_act) ? aco::choice(t.x, h.x, alpha, beta) : 0.0f;
    o.y = (row_ok && c + 1 < n_act) ? aco::choice(t.y, h.y, alpha, beta) : 0.0f;
    o.z = (row_ok && c + 2 < n_act) ? aco::choice(t.z, h.z, alpha, beta) : 0.0f;
    o.w = (row_ok && c + 3 < n_act) ? aco::choice(t.w, h.w, alpha, beta) : 0.0f;
    out[i] = o;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int aco_choice_info(const float* tau, const float* eta, float* out,
                               int n0, int n1, float alpha, float beta,
                               int n_actual, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n0 * n1;
  if (total == 0) return 0;
  if (n1 % 4 == 0 && aligned16(tau) && aligned16(eta) && aligned16(out)) {
    choice_info_kernel_vec4<<<aco::grid_for(total / 4, kBlock), kBlock, 0, s>>>(
        reinterpret_cast<const float4*>(tau),
        reinterpret_cast<const float4*>(eta), reinterpret_cast<float4*>(out),
        n0, n1, alpha, beta, n_actual);
  } else {
    choice_info_kernel<<<aco::grid_for(total, kBlock), kBlock, 0, s>>>(
        tau, eta, out, n0, n1, alpha, beta, n_actual);
  }
  return (int)cudaGetLastError();
}
