// Device functions shared by the construction kernels (choice_info,
// tour_select, fused_select, sparse_select) and the plain C interface's
// conventions: the selection transform and arg-max, and the threefry-2x32
// draw that the two walk kernels hash in registers.
//
// Every float operation that the plain PyTorch versions round separately
// is written with an explicit rounding intrinsic (__fmul_rn, __fadd_rn):
// nvcc contracts a*b+c into an FMA by default, which would change the
// last bit against the plain versions.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace aco {

// Selection modes, the reference's tour_select._transform modes.
enum Mode : int { kIRoulette = 0, kGumbel = 1, kGreedy = 2 };

// x^p with the static integer folding of repro/kernels/choice_info.py::_ipow:
// p == 1 -> x; integer p in 1..4 -> repeated products ((x*x)*x)*x; any other
// exponent -> powf.  The branch is uniform across a launch.
__device__ __forceinline__ float ipow(float x, float p) {
  if (p == 1.0f) return x;
  if (p == 2.0f) return __fmul_rn(x, x);
  if (p == 3.0f) return __fmul_rn(__fmul_rn(x, x), x);
  if (p == 4.0f) return __fmul_rn(__fmul_rn(__fmul_rn(x, x), x), x);
  return powf(x, p);
}

// The paper's choice value tau^alpha * eta^beta.
__device__ __forceinline__ float choice(float tau, float eta, float alpha,
                                        float beta) {
  return __fmul_rn(ipow(tau, alpha), ipow(eta, beta));
}

// Per-city score whose arg-max is the selected city: the reference's
// tour_select._transform, with its constants rounded to float32 as JAX
// rounds a Python float.  `keep` is the tabu/phantom mask (1 = selectable).
template <int MODE>
__device__ __forceinline__ float transform(float w, bool keep, float u) {
  if (MODE == kIRoulette) {
    return __fmul_rn(__fmul_rn(w, u), keep ? 1.0f : 0.0f);
  } else if (MODE == kGumbel) {
    const float lo = (float)1e-12;
    const float hi = (float)(1.0 - 1e-7);
    const float c = fminf(fmaxf(u, lo), hi);
    const float g = -logf(-logf(c));
    if (w > 0.0f && keep) return __fadd_rn(logf(fmaxf(w, (float)1e-38)), g);
    return (float)-1e30;
  } else {
    return keep ? w : (float)-1e30;
  }
}

// Running (value, index) arg-max.  Ties keep the lowest index, and NaN
// counts as the largest value, as jnp.argmax and torch.argmax do: the
// Pallas kernels' first-max-in-tile plus strict > across tiles is exactly
// this global first arg-max.
struct ArgMax {
  float val;
  int idx;  // INT_MAX = empty

  __device__ __forceinline__ static ArgMax empty() { return {0.0f, INT_MAX}; }

  // true if (v, i) beats (val, idx)
  __device__ __forceinline__ bool beaten_by(float v, int i) const {
    if (i == INT_MAX) return false;
    if (idx == INT_MAX) return true;
    const bool vn = isnan(v), cn = isnan(val);
    if (vn != cn) return vn;
    if (!vn && v != val) return v > val;
    return i < idx;
  }

  __device__ __forceinline__ void take(float v, int i) {
    if (beaten_by(v, i)) { val = v; idx = i; }
  }
};

// Block-wide arg-max of every thread's ArgMax; the result is valid in
// thread 0.  BLOCK is a multiple of 32, at most 1024.
template <int BLOCK>
__device__ __forceinline__ ArgMax block_argmax(ArgMax a) {
  static_assert(BLOCK % 32 == 0 && BLOCK <= 1024, "block size");
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, a.val, off);
    const int i = __shfl_down_sync(0xffffffffu, a.idx, off);
    a.take(v, i);
  }
  __shared__ float s_val[BLOCK / 32];
  __shared__ int s_idx[BLOCK / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { s_val[warp] = a.val; s_idx[warp] = a.idx; }
  __syncthreads();
  if (warp == 0) {
    a = (lane < BLOCK / 32) ? ArgMax{s_val[lane], s_idx[lane]}
                            : ArgMax::empty();
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, a.val, off);
      const int i = __shfl_down_sync(0xffffffffu, a.idx, off);
      a.take(v, i);
    }
  }
  return a;
}

// ------------------------------------------------------- the threefry draw

// Draw layouts of the step's (m, n) uniform: sampling.uniform (packed) and
// sampling.counter_uniform (counter).
enum Draw : int { kPacked = 0, kCounter = 1 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define ACO_TF4(r0, r1, r2, r3)               \
  x0 += x1; x1 = rotl(x1, r0) ^ x0;           \
  x0 += x1; x1 = rotl(x1, r1) ^ x0;           \
  x0 += x1; x1 = rotl(x1, r2) ^ x0;           \
  x0 += x1; x1 = rotl(x1, r3) ^ x0;

// Threefry-2x32, 20 rounds (core/sampling.threefry2x32, jax.random's hash).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  ACO_TF4(13, 15, 26, 6)  x0 += k1; x1 += k2 + 1u;
  ACO_TF4(17, 29, 16, 24) x0 += k2; x1 += k0 + 2u;
  ACO_TF4(13, 15, 26, 6)  x0 += k0; x1 += k1 + 3u;
  ACO_TF4(17, 29, 16, 24) x0 += k1; x1 += k2 + 4u;
  ACO_TF4(13, 15, 26, 6)  x0 += k2; x1 += k0 + 5u;
}
#undef ACO_TF4

// fold_in(key, t) = threefry(key, (0, t)) (sampling.fold_in): the key of
// construction step t.
__device__ __forceinline__ uint2 fold_in(uint32_t k0, uint32_t k1,
                                         uint32_t t) {
  uint32_t x0 = 0u, x1 = t;
  threefry2x32(k0, k1, x0, x1);
  return make_uint2(x0, x1);
}

// U[lo, lo + span) at (ant a, city c) of the step's (m, n) draw: packed,
// y0 ^ y1 of threefry(key, (hi, lo) of a n + c); counter, y0 of
// threefry(key, (a 65536 + c, 0)); then sampling._uniform_from_bits with
// its one-rounding multiply-add.
__device__ __forceinline__ float draw_at(uint32_t k0, uint32_t k1, int a,
                                         int c, int n, int draw, float lo,
                                         float span) {
  uint32_t x0, x1;
  if (draw == kPacked) {
    const unsigned long long flat = (unsigned long long)a * n + c;
    x0 = (uint32_t)(flat >> 32);
    x1 = (uint32_t)flat;
  } else {
    x0 = (uint32_t)a * 65536u + (uint32_t)c;
    x1 = 0u;
  }
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = draw == kPacked ? (x0 ^ x1) : x0;
  const float flo = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                              1.0f);
  return fmaxf(lo, __fmaf_rn(flo, span, lo));
}

// Grid size for a grid-stride loop over `work` items.
inline int grid_for(long long work, int block) {
  long long g = (work + block - 1) / block;
  if (g < 1) g = 1;
  if (g > 132 * 32) g = 132 * 32;
  return (int)g;
}

}  // namespace aco
