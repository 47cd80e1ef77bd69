// The paper's Choice kernel: out = tau^alpha * eta^beta elementwise over an
// (n0, n1) matrix, with rows and columns >= n_actual pinned to 0.
//
// Replaces repro/kernels/choice_info.py::choice_info (_choice_kernel).
// Bound: bytes -- 12 bytes per cell (two float reads, one float write) and
// at most a few multiplies; at n = 1002 that is 12 MB, ~3.6 us at 3.35 TB/s.
// Design: one grid-stride pass per instance, 16-byte float4 loads and
// stores where the row width is a multiple of 4 and the pointers are
// 16-byte aligned (then every plane of a stack is: its stride is n0 n1 4
// bytes).  The instance axis (the reference's vmapped kernel) is
// blockIdx.y: the base pointers move by the plane stride, the instance's
// n_actual comes from a device array when one is given, and an inactive
// instance's blocks return at once.  A single matrix is the batch-1 case.
#include <cstdint>

#include "aco_common.cuh"

namespace {

constexpr int kBlock = 256;

// The instance of this block: false when it is inactive; else its
// n_actual (from the device array when there is one) and the offset of its
// plane, in elements of `plane` per instance.
__device__ __forceinline__ bool take_plane(long long plane, int& n_act,
                                           const int* n_arr,
                                           const unsigned char* active,
                                           long long& offset) {
  const int b = blockIdx.y;
  if (active != nullptr && active[b] == 0) return false;
  if (n_arr != nullptr) n_act = n_arr[b];
  offset = (long long)b * plane;
  return true;
}

__global__ void choice_info_kernel(const float* __restrict__ tau,
                                   const float* __restrict__ eta,
                                   float* __restrict__ out, int n0, int n1,
                                   float alpha, float beta, int n_act,
                                   const int* __restrict__ n_arr,
                                   const unsigned char* __restrict__ active) {
  const long long total = (long long)n0 * n1;
  long long off;
  if (!take_plane(total, n_act, n_arr, active, off)) return;
  tau += off;
  eta += off;
  out += off;
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
                                        int n_act,
                                        const int* __restrict__ n_arr,
                                        const unsigned char* __restrict__
                                            active) {
  const long long total = (long long)n0 * n1 / 4;
  long long off;
  if (!take_plane(total, n_act, n_arr, active, off)) return;
  tau += off;
  eta += off;
  out += off;
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

// tau, eta, out: (batch, n0, n1).  n_actual: every instance's real-city
// count, or n_arr (batch,) on the device with each instance's; active
// (batch,) bytes, or null: an inactive instance's plane of out is left as
// it was.
extern "C" int aco_choice_info(const float* tau, const float* eta, float* out,
                               int batch, int n0, int n1, float alpha,
                               float beta, int n_actual, const int* n_arr,
                               const unsigned char* active, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)n0 * n1;
  if (total == 0 || batch == 0) return 0;
  if (batch < 0 || batch > 65535) return (int)cudaErrorInvalidValue;
  if (n1 % 4 == 0 && aligned16(tau) && aligned16(eta) && aligned16(out)) {
    const dim3 grid(aco::grid_for(total / 4, kBlock), batch);
    choice_info_kernel_vec4<<<grid, kBlock, 0, s>>>(
        reinterpret_cast<const float4*>(tau),
        reinterpret_cast<const float4*>(eta), reinterpret_cast<float4*>(out),
        n0, n1, alpha, beta, n_actual, n_arr, active);
  } else {
    const dim3 grid(aco::grid_for(total, kBlock), batch);
    choice_info_kernel<<<grid, kBlock, 0, s>>>(tau, eta, out, n0, n1, alpha,
                                               beta, n_actual, n_arr, active);
  }
  return (int)cudaGetLastError();
}
